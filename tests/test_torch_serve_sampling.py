"""The serve CLI's sampling in the port, on the CPU: ``--temperature`` > 0
draws each generated token from ``softmax(logits / temperature)`` with a
``torch.Generator`` seeded by ``--seed`` (``distributed.steps.
make_serve_step``). JAX's PRNG draws other bits than torch's, so the
reference's sampled tokens cannot be matched: these tests hold the port
to itself (the same seed, the same tokens) and to its greedy loop (a
temperature near 0 picks the argmax, which tests/test_torch_transformer.py
holds against the reference).
"""

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_launch
from repro_torch.launch.serve import serve_decode
from repro_torch.models import transformer as T

B, PROMPT, GEN = 2, 3, 6


def _decode(temperature, seed=0):
    cfg = get_smoke("qwen3-8b")
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return serve_decode(cfg, params, B, PROMPT, GEN, seed=seed,
                        device="cpu", temperature=temperature)


def test_the_same_seed_samples_the_same_tokens():
    a, b, c = _decode(1.0, 7), _decode(1.0, 7), _decode(1.0, 8)
    assert a.tokens.shape == (B, GEN) and a.tokens.dtype == np.int32
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.prompts, b.prompts)
    assert not np.array_equal(a.tokens, c.tokens)
    # at temperature 1 the draws are not the greedy tokens
    assert not np.array_equal(a.tokens, _decode(0.0, 7).tokens)


def test_a_temperature_near_zero_gives_the_greedy_tokens():
    greedy = _decode(0.0, 3)
    np.testing.assert_array_equal(_decode(1e-4, 3).tokens, greedy.tokens)


def test_the_cli_samples_at_a_temperature(capsys):
    argv = ["--arch", "mamba2-2.7b", "--smoke", "--batch", "2",
            "--prompt-len", "2", "--gen", "4", "--temperature", "0.8",
            "--seed", "5", "--device", "cpu"]
    first = serve_launch.main(argv)
    assert "temperature=0.8" in capsys.readouterr().out
    np.testing.assert_array_equal(serve_launch.main(argv), first)
