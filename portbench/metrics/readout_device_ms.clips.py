"""Device ms per batch of the kernels other than the one-shot cascade
kernel: the readout (kernel_machine.forward, or the twin's standardize_q
and classifier_q), the ADC quantization and the glue."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "clips":
        return None
    t = readings.per_unit(ctx, lambda n: not readings.is_copy(n)
                          and readings.ONESHOT_CASCADE not in n)
    return None if t is None else t * 1e3
