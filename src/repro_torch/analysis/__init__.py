"""Static analysis over the port's traced integer programs: the
verification layer for the multiplierless datapath, on ``torch.fx``
graphs of aten ops (the counterpart of the reference's ``repro.analysis``
over jaxprs).

``traverse``
    Tracing (``make_fx``, fake tensors, source locations on every node),
    the input-dependence of each node and the values of the others.
``legality``
    Op-legality whitelist (multiplierless by construction) and the op
    census in the reference's buckets.
``intervals``
    Worst-case interval analysis: proves every integer intermediate fits
    int32 for any input in the declared ranges.
``determinism``
    Lint for bit-parity hazards (float ops in a fixed program, free-tree
    float reductions).
``targets``
    The standard targets with the reference's input contracts.
``report``
    The report in ``ANALYSIS.json``'s schema (``python -m
    repro_torch.analysis``).
"""

from repro_torch.analysis.determinism import lint_determinism  # noqa: F401
from repro_torch.analysis.intervals import (  # noqa: F401
    Interval,
    IntervalResult,
    analyze_intervals,
)
from repro_torch.analysis.legality import (  # noqa: F401
    assert_multiplierless,
    census,
    check_legality,
)
from repro_torch.analysis.traverse import Traced, trace  # noqa: F401
