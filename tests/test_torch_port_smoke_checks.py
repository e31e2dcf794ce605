"""chip_smoke.py's attn_tail forward bound on the CPU: scaled by |out - x| +
|x| (`attn_tail_scale`), it takes one bf16 ulp of the proj output where the
residual add cancels, which the bound scaled by |out| alone refuses, and it
still refuses an error of the output's own size."""
import pytest
import torch

import chip_smoke


def _cancelling():
    """x 4.3125, proj -4.28125: out = 0.03125 in bf16; the kernel's proj
    one ulp (2^-5 at 4.28) away gives out 0.0625."""
    x = torch.tensor([4.3125, 1.0, -2.0], dtype=torch.bfloat16)
    want = torch.tensor([0.03125, 1.5, -1.0], dtype=torch.bfloat16)
    got = torch.tensor([0.0625, 1.5, -1.0], dtype=torch.bfloat16)
    return x, want, got


def test_one_proj_ulp_where_the_add_cancels_passes_the_scaled_bound():
    x, want, got = _cancelling()
    with pytest.raises(AssertionError, match="1 elements outside"):
        chip_smoke.compare("attn_tail", got, want)
    scale, cancel = chip_smoke.attn_tail_scale(x, want, got)
    assert chip_smoke.compare("attn_tail", got, want, scale=scale) == 0.03125
    assert cancel == {"n": 1, "worst": {"out": 0.03125, "x": 4.3125, "proj": -4.28125,
                                         "err": 0.03125}}


def test_the_scaled_bound_still_refuses_a_wrong_output():
    x, want, _ = _cancelling()
    got = want.clone()
    got[1] = 1.75  # off by 1/6 of |out| where nothing cancels
    scale, cancel = chip_smoke.attn_tail_scale(x, want, got)
    assert cancel["n"] == 1
    with pytest.raises(AssertionError, match="1 elements outside"):
        chip_smoke.compare("attn_tail", got, want, scale=scale)
