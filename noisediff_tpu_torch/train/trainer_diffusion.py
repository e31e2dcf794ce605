"""Stage-1 trainer, test phase: bulk noise generation.

Port of the generation half of noisediff_tpu/train/trainer_diffusion.py
(reference `models/trainer_diffusion.py` Trainer, test :240-325): dataset by
name, network by --net_name, GaussianDiffusion with the sampler chosen by
--sampler, and `.test()` writing one CHW float32 .npy per patch under
deterministic 'clean+noisy+x_y.npy' names, through a background writer
thread with tmp + os.replace writes. Training waits for a later slice.

Each batch draws its noise from its own torch.Generator seeded from
(random_seed, batch index), so --skip_existing can resume a run and a
regenerated batch equals the one an uninterrupted run wrote.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..cli.common import resolve_device, set_precision_flags
from ..config import paths_from_args
from ..data.datasets import DATASETS
from ..data.loader import generation_loader
from ..diffusion.gaussian import GaussianDiffusion, default_dpm_steps
from ..models import define_network
from ..ops.schedules import make_schedule
from ..weights import load_into

# salt of the per-batch generator seeds (the JAX trainer folds 999 into its key)
_SAMPLE_STREAM = 999


def batch_seed(random_seed: int, batch_index: int) -> int:
    """Seed of batch `batch_index`'s generator: a pure function of the run
    seed and the batch, independent of which batches were skipped."""
    seq = np.random.SeedSequence([int(random_seed), _SAMPLE_STREAM, int(batch_index)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    def __init__(self, args):
        if args.phase != "test":
            raise NotImplementedError("training is not ported yet (see ROADMAP.md, Queue 1)")
        if getattr(args, "launcher", "none") != "none":
            raise NotImplementedError("multi-process generation is not ported yet (ROADMAP.md)")
        self.args = args
        self.device = resolve_device(getattr(args, "device", "cuda"))
        set_precision_flags()
        self.paths = paths_from_args(args)
        seed = getattr(args, "random_seed", 0)
        self.seed = seed
        mixed = getattr(args, "mixed_precision", True)
        self.compute_dtype = torch.bfloat16 if mixed else None

        ds_cls = DATASETS[args.testset]
        kwargs = {}
        if args.testset == "NoiseImageGenerationDataset":
            kwargs = dict(iso_value=args.iso_value, ratio_value=args.ratio_value)
        self.test_dataset = ds_cls(self.paths, args.crop_size, seed=seed, **kwargs)
        self.test_dataloader = generation_loader(
            self.test_dataset, args.batch_size, getattr(args, "num_workers", 0))

        # initial weights from the run seed, without touching the global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = define_network(args.net_name, args, dtype=self.compute_dtype)
        if args.resume and args.resume != ".":
            # "." is the reference CLI's default (test_diffusion.py:73): no checkpoint
            load_into(model, args.resume)  # .pth/.pt or a JAX .npz snapshot, strict
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.model.requires_grad_(False)
        logging.info("generator parameters: %f",
                     sum(p.numel() for p in self.model.parameters()) / 1e6)

        self.diffusion = GaussianDiffusion(
            self.model,
            make_schedule(args.beta_schedule, args.diffusion_steps),
            image_size=args.crop_size,
            objective=args.diffusion_objective,
            sampling_timesteps=getattr(args, "sampling_timesteps", None),
            auto_normalize=getattr(args, "auto_normalize", False),
            device=self.device,
        )

    def sampler(self, batch_size: int) -> Callable:
        """The sampler --sampler selects (trainer_diffusion.py:389-441):
        dpm -> DPM-Solver++(2M) on --dpm_spacing; ddim, or auto with fewer
        sampling steps than T -> DDIM; otherwise ancestral DDPM."""
        gd = self.diffusion
        shape = (batch_size, self.args.crop_size, self.args.crop_size, 4)
        kind = getattr(self.args, "sampler", "auto")
        spacing = getattr(self.args, "dpm_spacing", "lambda")
        if kind == "dpm":  # resolved (and reported) once per run, not per batch
            dpm_steps = gd.sampling_timesteps or default_dpm_steps(spacing, warn=True)

        def fn(condition, generator):
            if kind == "dpm":
                return gd.dpm_solver_sample(shape, condition, sampling_timesteps=dpm_steps,
                                            step_spacing=spacing, generator=generator)
            if kind == "ddim" or (kind == "auto" and gd.is_ddim_sampling):
                return gd.ddim_sample(shape, condition, generator=generator)
            return gd.p_sample_loop(shape, condition, generator=generator)

        return fn

    def _names(self, batch, npy_num: int) -> List[str]:
        """Output names, a pure function of the grid walk (:490-506)."""
        args = self.args
        names = []
        if not getattr(args, "save_npy", False):
            return names
        for i in range(len(batch["image_coord"])):
            image_coord = batch["image_coord"][i]
            if not getattr(args, "dark_frame", False):
                clean_name = batch["clean_name"][i].split(".ARW")[0].split(".npy")[0]
                noisy_name = batch.get("noisy_name", batch["clean_name"])[i]
                noisy_name = noisy_name.split(".ARW")[0].split(".npy")[0]
                names.append(f"{clean_name}+{noisy_name}+{image_coord}.npy")
            else:
                iso_i, ratio_i = int(batch["iso"][i]), int(batch["ratio"][i])
                names.append(f"{npy_num + i:05d}_{iso_i}_{ratio_i}+{image_coord}.npy")
        return names

    def test(self) -> Dict[str, object]:
        """Generate every batch, write the npy files, and return what was
        done: {'generated', 'skipped', 'batches', 'batch_seconds', 'out_dir'};
        batch_seconds holds each sampled batch's time, synchronised with the
        device."""
        args = self.args
        out_dir = os.path.join(args.save_folder, "npy", "generated")
        os.makedirs(out_dir, exist_ok=True)

        # background npy writer: disk IO overlaps the next batch
        write_q: "queue.Queue" = queue.Queue(maxsize=64)
        write_errors: List[BaseException] = []

        def writer():
            while True:
                item = write_q.get()
                if item is None:
                    return
                name, arr = item
                dst = os.path.join(out_dir, name)
                tmp = dst + ".tmp.npy"  # .npy suffix stops np.save renaming it
                try:
                    np.save(tmp, arr)
                    os.replace(tmp, dst)  # a preemption never leaves a partial .npy
                except OSError as exc:
                    write_errors.append(exc)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        bs = args.batch_size
        sample_fn = self.sampler(bs)
        npy_num = n_skipped = n_batches = 0
        batch_seconds: List[float] = []
        t0 = time.time()
        try:
            for bidx, batch in enumerate(self.test_dataloader):
                n = batch["coord"].shape[0]
                names = self._names(batch, npy_num)
                if (names and getattr(args, "skip_existing", False)
                        and all(os.path.exists(os.path.join(out_dir, nm)) for nm in names)):
                    npy_num += n
                    n_skipped += n
                    continue

                def pad(x):
                    if x.shape[0] == bs:
                        return x
                    return np.concatenate([x] + [x[-1:]] * (bs - x.shape[0]), axis=0)

                coord = pad(batch["coord"])
                if getattr(args, "dark_frame", False) or "clean_img" not in batch:
                    clean = np.zeros(coord.shape[:3] + (4,), np.float32)
                else:
                    clean = pad(batch["clean_img"])
                if not getattr(args, "positional_encoding", True):
                    coord = np.zeros_like(coord)
                dev = self.device
                condition = {
                    "clean_img": torch.from_numpy(clean).to(dev),
                    "position": torch.from_numpy(coord).to(dev),
                    "iso_ratio_idx": torch.from_numpy(pad(batch["iso_ratio_idx"])).to(dev),
                }
                generator = torch.Generator(device=dev)
                generator.manual_seed(batch_seed(self.seed, bidx))
                tb = time.perf_counter()
                output = sample_fn(condition, generator)
                output = output[:n].float().cpu().numpy()  # waits for the device
                batch_seconds.append(time.perf_counter() - tb)
                n_batches += 1
                for i, save_name in enumerate(names):
                    # reference-compatible CHW layout (trainer_diffusion.py:317)
                    write_q.put((save_name, output[i].transpose(2, 0, 1)))
                npy_num += len(names)
        finally:
            write_q.put(None)
            wt.join()
        if write_errors:
            raise write_errors[0]
        logging.info("generated %d patches in %.1fs (%d already on disk, skipped)",
                     npy_num - n_skipped, time.time() - t0, n_skipped)
        return {
            "generated": npy_num - n_skipped,
            "skipped": n_skipped,
            "batches": n_batches,
            "batch_seconds": batch_seconds,
            "out_dir": out_dir,
        }
