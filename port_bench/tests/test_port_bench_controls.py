"""`correct` against its controls and faults, at sizes a test run holds.

Each test drives a cell's driver through a whole run on the CPU (the look
for a card skipped, the configuration and traffic cut to a small size,
the cell's committed limits kept), with the program sound, with the
control one precision below in its place, or with the timed path broken
underneath: a sampler step that returns its state unchanged, a patch, a
frame, a PSNR or an SSIM altered where it is produced. The sound run has
to come out correct, every other not. The TF32 control of the fp32 cell
exists only on a card.
"""
import inspect
import time

import pytest
import torch

import run
from harness import common

SMALL = {
    "ndn48.gen-dpm10-b4": ({"dim": 16}, {"batch": 2, "crop": 32, "frame": [64, 96], "grid": 32,
                                         "pool": 2, "sample": 1}),
    "lsid.eval-sid-fullframe": ({"base_width": 8}, {"bayer": [96, 128], "pool": 2,
                                                    "sample": 1}),
}
SEED = 2 ** 33 + 17


def _run(cell, device=torch.device("cpu"), control=None, seconds=0.3):
    bench = common.benchmark()
    c = common.cell(cell, bench)
    cfg, tr = SMALL[cell]
    c["config_file"].update(cfg)
    c["traffic_file"].update(tr)
    return run.execute(c, SEED, seconds, False, device, bench, t_start=time.perf_counter(),
                       control=control)


def _failed(result):
    return [k for k, v in result["checks"].items() if v["value"] > v["limit"]]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_sound_program_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]


def test_the_int8_control_is_not_correct():
    result = _run("ndn48.gen-dpm10-b4", control="int8")
    assert not result["correct"], result["checks"]


def test_the_tf32_control_is_not_correct_on_a_card(cuda):
    result = _run("lsid.eval-sid-fullframe", cuda, control="tf32")
    assert not result["correct"], result["checks"]


def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def _sampler_with(edit):
    """The port's DPM sampler with one line of its step replaced."""
    from noisediff_tpu_torch.diffusion import gaussian

    src = inspect.getsource(gaussian.GaussianDiffusion.dpm_solver_sample)
    line = "x = _f32(ratio) * x - _f32(a_n[i] * ph[i]) * d"
    assert line in src
    src = "\n".join(s[4:] for s in src.replace(line, edit).splitlines())
    scope = dict(vars(gaussian))
    exec(compile(src, gaussian.__file__, "exec"), scope)
    return scope["dpm_solver_sample"]


def _gen_state_unchanged():
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion

    return _patched(GaussianDiffusion, "dpm_solver_sample", _sampler_with(
        "x = x if i == 1 else _f32(ratio) * x - _f32(a_n[i] * ph[i]) * d"))


def _gen_patch_altered():
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion

    sample = GaussianDiffusion.dpm_solver_sample

    def altered(self, *a, **k):
        out = sample(self, *a, **k)
        out = out.clone()
        out[0] += 0.1
        return out
    return _patched(GaussianDiffusion, "dpm_solver_sample", altered)


def _eval_psnr_altered():
    from noisediff_tpu_torch.ops import metrics

    psnr = metrics.psnr
    return _patched(metrics, "psnr", lambda *a, **k: psnr(*a, **k) + 0.01)


def _eval_frame_altered():
    from noisediff_tpu_torch.ops import metrics

    correct = metrics.illuminance_correct
    return _patched(metrics, "illuminance_correct", lambda p, s: correct(p, s) * 1.001)


def _eval_ssim_altered():
    from noisediff_tpu_torch.ops import metrics

    ssim = metrics.ssim
    return _patched(metrics, "ssim", lambda *a, **k: ssim(*a, **k) * 1.01)


FAULTS = {
    "gen state unchanged": ("ndn48.gen-dpm10-b4", _gen_state_unchanged),
    "gen patch altered": ("ndn48.gen-dpm10-b4", _gen_patch_altered),
    "eval psnr altered": ("lsid.eval-sid-fullframe", _eval_psnr_altered),
    "eval frame altered": ("lsid.eval-sid-fullframe", _eval_frame_altered),
    "eval ssim altered": ("lsid.eval-sid-fullframe", _eval_ssim_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault):
    cell, plant = FAULTS[fault]
    undo = plant()
    try:
        result = _run(cell)
    finally:
        undo()
    assert _failed(result), (fault, result["checks"])
    assert not result["correct"]


def test_the_faults_leave_the_port_as_it_was():
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.ops import metrics

    before = (GaussianDiffusion.dpm_solver_sample, metrics.psnr, metrics.ssim,
              metrics.illuminance_correct)
    for _, plant in FAULTS.values():
        plant()()
    after = (GaussianDiffusion.dpm_solver_sample, metrics.psnr, metrics.ssim,
             metrics.illuminance_correct)
    assert before == after
