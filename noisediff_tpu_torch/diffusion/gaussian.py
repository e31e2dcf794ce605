"""Gaussian diffusion: the training loss, DPM-Solver++(2M), DDIM and
ancestral DDPM sampling, the `sample` dispatcher and latent interpolation.

Port of noisediff_tpu/diffusion/gaussian.py (reference
`models/denoising_diffusion_pytorch.py`, GaussianDiffusion :167-542). The
JAX `lax.scan` bodies become Python loops; the per-step scalars are
computed on the host exactly as the JAX package computes them, and the
sample carry is fp32 whatever the model's compute dtype. Randomness comes
from a caller's `torch.Generator`; the JAX package's random streams cannot
be reproduced, so `init_noise` lets a caller (and the tests) fix x_T,
`p_losses` / `loss` take the noise and the timesteps from the caller, and
`interpolate` its draws. Under a spatial shard (parallel/mesh.activate)
the samplers' shape is this rank's rows of the frame, and each draw is
made for the whole frame and sliced (`_randn`).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cli.common import resolve_device
from ..ops.kernels.ddim_head import (
    ddim_step_scalars, fused_ddim_head_update, reference_ddim_head_update)
from ..ops.schedules import DiffusionSchedule, make_schedule
from ..parallel import mesh

Condition = Optional[Dict[str, torch.Tensor]]
ModelFn = Callable[[torch.Tensor, torch.Tensor, Condition], torch.Tensor]
# (x, t, condition) -> (h, shot, shot_res, head weights): the model's trunk
# and its dual head's parameters, for the fused DDIM tail
TrunkFn = Callable[[torch.Tensor, torch.Tensor, Condition],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]]

OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")
_BUFFERS = (
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2",
    "posterior_variance", "posterior_log_variance_clipped",
)


def _dpm_step_grid(alphas_cumprod, steps: int, spacing: str):
    """Descending DPM-Solver knot list `[T-1, ..., -1]` for a discrete
    schedule (gaussian.py:58-94).

    'time': DDIM's uniform-in-t linspace grid (reference :409-411), with
    its duplicate knots when steps approaches T. 'lambda': uniform in
    half-log-SNR; interior knots land on the nearest discrete t, forced
    strictly decreasing, and a knot that would collide at t=0 is dropped.
    Raises where the JAX grid would produce non-finite knots (a schedule
    whose alphas_cumprod underflows to 0)."""
    ac = np.asarray(alphas_cumprod, np.float64)
    total = len(ac)
    if steps < 1:
        raise ValueError(f"need at least one step, got {steps}")
    if spacing == "lambda":
        if not np.all(ac > 0.0):
            raise ValueError("lambda step grid needs alphas_cumprod > 0 at every t")
        lam_all = 0.5 * np.log(ac / np.maximum(1.0 - ac, 1e-300))
        targets = np.linspace(lam_all[total - 1], lam_all[0], steps + 1)
        times = [total - 1]
        for tg in targets[1:-1]:
            tk = int(np.argmin(np.abs(lam_all - tg)))
            tk = max(min(tk, times[-1] - 1), 0)
            if tk < times[-1]:
                times.append(tk)
        times.append(-1)
    elif spacing == "time":
        times = np.linspace(-1, total - 1, steps + 1).astype(np.int64)
        times = list(reversed(times.tolist()))
    else:
        raise ValueError(f"step_spacing must be 'time' or 'lambda', got {spacing!r}")
    return times


def default_dpm_steps(step_spacing: str, warn: bool = False) -> int:
    """The KLD-certified DPM-Solver step count of each grid when none is
    given: 10 on the lambda grid, 15 on the time grid
    (DPM_STEP_SWEEP.json)."""
    steps = 10 if step_spacing == "lambda" else 15
    if warn:
        logging.getLogger("noisediff").warning(
            "dpm_solver_sample: no step count given; using the KLD-certified default "
            "%d for the %r grid", steps, step_spacing)
    return steps


def _f32(v) -> float:
    """A host scalar as the float32 value the JAX scan consumes."""
    return float(np.float32(v))


class GaussianDiffusion:
    """Conditional DDPM training loss and sampling with pred_noise / pred_x0
    / pred_v.

    `model_fn(x, t, condition)` is the denoiser, NHWC in and out. The
    schedule's buffers live on `device`: the card unless the caller names
    the CPU; without a card that raises, as the CLIs' `--device cuda` does."""

    def __init__(self, model_fn: ModelFn, schedule: DiffusionSchedule, image_size: int,
                 channels: int = 4, objective: str = "pred_v",
                 sampling_timesteps: Optional[int] = None, ddim_sampling_eta: float = 0.0,
                 auto_normalize: bool = False, device="cuda"):
        if objective not in OBJECTIVES:
            raise ValueError(f"objective must be one of {OBJECTIVES}")
        if sampling_timesteps is not None and sampling_timesteps > schedule.num_timesteps:
            raise ValueError("sampling_timesteps exceeds the schedule length")
        self.model_fn = model_fn
        self.schedule = schedule
        self.image_size = image_size
        self.channels = channels
        self.objective = objective
        self.sampling_timesteps = sampling_timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.auto_normalize = auto_normalize
        self.device = resolve_device(device)
        self.buffers = {
            name: torch.from_numpy(getattr(schedule, name)).to(self.device) for name in _BUFFERS
        }
        self.loss_weight = torch.from_numpy(schedule.loss_weight(objective)).to(self.device)

    @classmethod
    def create(cls, model_fn: ModelFn, *, image_size: int, timesteps: int = 1000,
               beta_schedule: str = "sigmoid", **kwargs) -> "GaussianDiffusion":
        return cls(model_fn, make_schedule(beta_schedule, timesteps), image_size, **kwargs)

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def is_ddim_sampling(self) -> bool:
        # reference :235 — DDIM only when strictly fewer sampling steps
        return (self.sampling_timesteps is not None
                and self.sampling_timesteps < self.num_timesteps)

    def normalize(self, x):
        return x * 2.0 - 1.0 if self.auto_normalize else x

    def unnormalize(self, x):
        return (x + 1.0) * 0.5 if self.auto_normalize else x

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = self.buffers[name][t]
        return out.reshape(out.shape + (1,) * (ndim - out.ndim))

    # -- x0 / eps / v conversions (:298-320) ---------------------------------
    def predict_start_from_noise(self, x_t, t, noise):
        return (self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        return ((self._extract("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t - x0)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, x_t.ndim))

    def predict_v(self, x_start, t, noise):
        return (self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * noise
                - self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * x_start)

    def q_sample(self, x_start, t, noise):
        return (self._extract("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise)

    def predict_start_from_v(self, x_t, t, v):
        return (self._extract("sqrt_alphas_cumprod", t, x_t.ndim) * x_t
                - self._extract("sqrt_one_minus_alphas_cumprod", t, x_t.ndim) * v)

    def q_posterior(self, x_start, x_t, t):
        mean = (self._extract("posterior_mean_coef1", t, x_t.ndim) * x_start
                + self._extract("posterior_mean_coef2", t, x_t.ndim) * x_t)
        variance = self._extract("posterior_variance", t, x_t.ndim)
        log_variance = self._extract("posterior_log_variance_clipped", t, x_t.ndim)
        return mean, variance, log_variance

    def model_predictions(self, x, t, condition: Condition = None, clip_x_start: bool = False,
                          rederive_pred_noise: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred_noise, pred_x_start), reference :331-354."""
        model_output = self.model_fn(x, t, condition).float()

        def clip(v):
            return v.clamp(-1.0, 1.0) if clip_x_start else v

        if self.objective == "pred_noise":
            pred_noise = model_output
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == "pred_x0":
            x_start = clip(model_output)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, model_output))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return pred_noise, x_start

    # -- training loss (:473-542) --------------------------------------------
    def p_losses(self, x_start, t, condition: Condition = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The weighted training loss at timesteps t (B,): the per-sample MSE
        of the model output against the objective's target, times
        loss_weight[t], averaged over the batch; pred_x0 adds the L1 term on
        the per-channel spatial means (reference :524-528). `noise` defaults
        to a standard normal draw from `generator`."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
        x = self.q_sample(x_start, t, noise)
        model_out = self.model_fn(x, t, condition).float()
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        loss = (model_out - target).square().mean(dim=tuple(range(1, model_out.ndim)))
        loss = (loss * self.loss_weight[t]).mean()
        if self.objective == "pred_x0":
            loss = loss + (model_out.mean(dim=(1, 2)) - target.mean(dim=(1, 2))).abs().mean()
        return loss

    def loss(self, img, condition: Condition = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training objective (reference forward :534-542): t uniform in
        [0, T) from `generator` unless given, the image normalised, then
        p_losses. img: (B, H, W, C) NHWC."""
        b, h, w = img.shape[:3]
        if h != self.image_size or w != self.image_size:
            raise ValueError(f"height/width of image must be {self.image_size}, got {(h, w)}")
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator,
                              device=img.device)
        return self.p_losses(self.normalize(img), t, condition, noise=noise, generator=generator)

    def fused_tail_trunk(self) -> Optional[TrunkFn]:
        """The `trunk_fn` that takes DDIM through the fused tail: where the
        model has a trunk (`NoiseDiffNet.trunk`) and the objective is
        pred_v; None otherwise (the UNet_PosEmbV2 family, whose head is one
        1x1 conv, samples DDIM unfused, as in the JAX package)."""
        model = self.model_fn
        if not hasattr(model, "trunk") or self.objective != "pred_v":
            return None

        def trunk_fn(x, t, condition):
            return (*model.trunk(x, t, condition), model.head_weights())
        return trunk_fn

    def _randn(self, shape, generator) -> torch.Tensor:
        """A standard normal fp32 draw of `shape` on the diffusion's device.
        Under a spatial shard, `shape` (B, rows, W, C) holds this rank's
        rows: the draw is made for the whole frame and those rows kept, so
        every rank count draws what one process draws."""
        shard = mesh.spatial()
        if shard is None:
            return torch.randn(shape, generator=generator, device=self.device,
                               dtype=torch.float32)
        whole = (shape[0], shard.height, *shape[2:])
        return shard.rows(torch.randn(whole, generator=generator, device=self.device,
                                      dtype=torch.float32))

    def _init(self, shape, generator, init_noise) -> torch.Tensor:
        if init_noise is not None:
            return init_noise.to(device=self.device, dtype=torch.float32)
        return self._randn(shape, generator)

    def _timesteps(self, t: int, batch: int) -> torch.Tensor:
        return torch.full((batch,), int(t), dtype=torch.long, device=self.device)

    # -- DDPM ancestral sampler (:366-402) ------------------------------------
    @torch.inference_mode()
    def p_sample_loop(self, shape, condition: Condition = None,
                      generator: Optional[torch.Generator] = None,
                      init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-T ancestral sampling. `init_noise` overrides x_T."""
        x = self._init(shape, generator, init_noise)
        for t in range(self.num_timesteps - 1, -1, -1):
            tb = self._timesteps(t, shape[0])
            _, x_start = self.model_predictions(x, tb, condition)
            x_start = x_start.clamp(-1.0, 1.0)  # clip_denoised=True (:370)
            mean, _, log_var = self.q_posterior(x_start, x, tb)
            x = mean
            if t > 0:  # no noise at the last step (:371)
                noise = self._randn(shape, generator)
                x = x + torch.exp(0.5 * log_var) * noise
        return self.unnormalize(x)

    # -- DDIM sampler (:404-444) ----------------------------------------------
    @torch.inference_mode()
    def ddim_sample(self, shape, condition: Condition = None,
                    sampling_timesteps: Optional[int] = None, eta: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    init_noise: Optional[torch.Tensor] = None,
                    trunk_fn: Optional[TrunkFn] = None) -> torch.Tensor:
        """DDIM. With `trunk_fn` each step runs the model's trunk and then
        the fused tail (ops/kernels/ddim_head.py): the dual head, the pred_v
        clip and rederive and the DDIM update in one pass
        (gaussian.py:380-430 of the JAX package). It implements pred_v
        only. The tail is the ddim_head kernel where the model's head runs
        its kernel (`NoiseDiffNet.head_kernel`), else its plain version."""
        if trunk_fn is not None and self.objective != "pred_v":
            raise ValueError("fused DDIM tail implements the pred_v objective only")
        total = self.num_timesteps
        steps = sampling_timesteps or self.sampling_timesteps or total
        eta = self.ddim_sampling_eta if eta is None else eta
        # reference time grid (:409-411): linspace(-1, T-1, S+1), int, reversed pairs
        times = np.linspace(-1, total - 1, steps + 1).astype(np.int64)
        times = list(reversed(times.tolist()))
        pairs = list(zip(times[:-1], times[1:]))

        ac = self.schedule.alphas_cumprod  # float32, as the JAX scan reads it
        one = np.float32(1.0)
        x = self._init(shape, generator, init_noise)
        tail = (fused_ddim_head_update if getattr(self.model_fn, "head_kernel", True)
                else reference_ddim_head_update)
        for t, t_next in pairs:
            alpha = ac[t]
            # terminal step: alpha_next = 1 reduces the update to x = x_start
            alpha_next = one if t_next < 0 else ac[t_next]
            sigma = np.float32(eta) * np.sqrt(np.maximum(
                (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), np.float32(0)))
            c = np.sqrt(np.maximum(one - alpha_next - sigma ** 2, np.float32(0)))
            tb = self._timesteps(t, shape[0])
            # eta = 0 (the reference default) draws no noise
            noise = self._randn(shape, generator) if float(eta) != 0.0 else None
            if trunk_fn is not None:
                h, shot, shot_res, head = trunk_fn(x, tb, condition)
                x = tail(h, shot, shot_res, x, noise, *head,
                         ddim_step_scalars(alpha, alpha_next, sigma, c))
                continue
            pred_noise, x_start = self.model_predictions(
                x, tb, condition, clip_x_start=True, rederive_pred_noise=True)
            x = x_start * _f32(np.sqrt(alpha_next)) + _f32(c) * pred_noise
            if noise is not None:
                x = x + _f32(sigma) * noise
        return self.unnormalize(x)

    # -- DPM-Solver++(2M) (framework extension; not in the reference) ---------
    @torch.inference_mode()
    def dpm_solver_sample(self, shape, condition: Condition = None,
                          sampling_timesteps: Optional[int] = None,
                          init_noise: Optional[torch.Tensor] = None,
                          step_spacing: str = "lambda",
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Second-order multistep DPM-Solver++ (arXiv:2211.01095), data
        prediction, deterministic. The production grid is 10 steps on the
        lambda grid (the default here, as in the CLI; the JAX method's own
        signature defaults to 'time')."""
        steps = (sampling_timesteps or self.sampling_timesteps
                 or default_dpm_steps(step_spacing, warn=True))

        ac = np.asarray(self.schedule.alphas_cumprod, np.float64)
        times = _dpm_step_grid(ac, steps, step_spacing)
        pairs = np.array(list(zip(times[:-1], times[1:])), np.int64)

        def lam(t_idx):  # half log-SNR at discrete t; t = -1 is clean data
            if t_idx < 0:
                return 60.0
            return np.log(np.sqrt(ac[t_idx]) / np.sqrt(1.0 - ac[t_idx]))

        t_cur, t_next = pairs[:, 0], pairs[:, 1]
        lam_cur = np.array([lam(t) for t in t_cur])
        lam_next = np.array([lam(t) for t in t_next])
        lam_prev = np.concatenate([[lam_cur[0]], lam_cur[:-1]])
        h = lam_next - lam_cur
        h_prev = np.maximum(lam_cur - lam_prev, 1e-12)
        r = h_prev / np.maximum(np.abs(h), 1e-12)
        alpha_next = np.sqrt(np.where(t_next < 0, 1.0, ac[np.maximum(t_next, 0)]))
        sigma_next = np.sqrt(np.maximum(1.0 - alpha_next ** 2, 0.0))
        sigma_cur = np.sqrt(1.0 - ac[t_cur])
        phi = np.expm1(-h)
        # the scan consumes these as float32 (gaussian.py:535-538)
        a_n, s_n, s_c, ph, rr = (np.asarray(v, np.float32)
                                 for v in (alpha_next, sigma_next, sigma_cur, phi, r))

        x = self._init(shape, generator, init_noise)
        x0_prev = None
        for i, t in enumerate(t_cur):
            tb = self._timesteps(t, shape[0])
            _, x0 = self.model_predictions(x, tb, condition, clip_x_start=True)
            if x0_prev is None:  # first step: Euler
                d = x0
            else:  # 2M: D = (1 + 1/(2r)) x0 - 1/(2r) x0_prev
                coef = np.float32(1.0) / (np.float32(2.0) * np.maximum(rr[i], np.float32(1e-6)))
                d = _f32(np.float32(1.0) + coef) * x0 - _f32(coef) * x0_prev
            if s_n[i] == 0.0:  # terminal step: x -> x0
                x = x0
            else:
                ratio = s_n[i] / np.maximum(s_c[i], np.float32(1e-12))
                x = _f32(ratio) * x - _f32(a_n[i] * ph[i]) * d
            x0_prev = x0
        return self.unnormalize(x)

    # -- dispatcher (:446-451) --------------------------------------------------
    def sample(self, batch_size: int, condition: Condition = None,
               generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A batch of image_size^2 samples: DDIM where `is_ddim_sampling`
        (through the fused tail where `fused_tail_trunk` gives one), else
        ancestral DDPM."""
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        if self.is_ddim_sampling:
            return self.ddim_sample(shape, condition, generator=generator, init_noise=init_noise,
                                    trunk_fn=self.fused_tail_trunk())
        return self.p_sample_loop(shape, condition, generator=generator, init_noise=init_noise)

    # -- latent interpolation (:453-471) -----------------------------------------
    @torch.inference_mode()
    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, condition: Condition = None,
                    t: Optional[int] = None, lam: float = 0.5,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor, Sequence[torch.Tensor]]]
                    = None) -> torch.Tensor:
        """Noise x1 and x2 to step t (default T - 1) with q_sample, mix them
        as (1 - lam) x1_t + lam x2_t, then run the ancestral posterior loop
        from t - 1 down to 0 with x0 clipped to [-1, 1], adding noise at
        every step but the last. The draws come from `generator` (x1's
        noise, x2's, then each step's), or are given as `draws`: (x1's
        noise, x2's, [the noise of steps t - 1, ..., 1]). Not unnormalised,
        as in the reference."""
        t = self.num_timesteps - 1 if t is None else int(t)
        if x1.shape != x2.shape:
            raise ValueError(f"x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} differ in shape")
        b = x1.shape[0]

        def randn():
            return torch.randn(x1.shape, generator=generator, device=self.device)

        n1, n2, steps = draws if draws is not None else (randn(), randn(), None)
        if steps is not None and len(steps) != max(t - 1, 0):
            raise ValueError(f"interpolate from t={t} draws {max(t - 1, 0)} step noises, "
                             f"got {len(steps)}")
        tb = self._timesteps(t, b)
        x1, x2 = (v.to(device=self.device, dtype=torch.float32) for v in (x1, x2))
        x = ((1 - lam) * self.q_sample(x1, tb, n1.to(self.device))
             + lam * self.q_sample(x2, tb, n2.to(self.device)))
        for k, i in enumerate(range(t - 1, -1, -1)):
            ti = self._timesteps(i, b)
            _, x_start = self.model_predictions(x, ti, condition)
            mean, _, log_var = self.q_posterior(x_start.clamp(-1.0, 1.0), x, ti)
            x = mean
            if i > 0:
                noise = randn() if steps is None else steps[k].to(self.device)
                x = x + torch.exp(0.5 * log_var) * noise
        return x
