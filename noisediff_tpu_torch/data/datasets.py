"""The datasets of the reference, host-side.

Port of noisediff_tpu/data/datasets.py:
  SonyTrainDataset                  reference dataloader/dataset.py:29-145
  NoiseImageGenerationDataset       reference dataloader/dataset.py:152-281
  GenDarkFrameDataset               dataset.py:293-415
  SyntheticNoisDiffDenoisingDataset dataloader/dataset_denoising.py:29-168
  RealSonyDenoisingDataset          dataset_denoising.py:172-265
  PossionGaussianDenoisingDataset   dataset_denoising.py:271-372
Items are dicts of numpy arrays and python scalars with the reference's key
names, images HWC float32, so the trainers and the npy export contract line
up with the JAX package's. Every item's draws come from its (seed, epoch,
index) generator, and the arithmetic is the JAX package's, so an item equals
the JAX dataset's array for array on the same tree and seed.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.coords import crop_coord_patch
from . import manifest, native
from .iso_ratio_mapping import COMBINATION_MAPPING
from .raw_host import (
    SCALE,
    Darkshading,
    PackedFrameCache,
    load_packed_frame,
    np_pack_bayer,
    np_unpack_bayer,
    open_bayer,
)


@dataclasses.dataclass
class DataPaths:
    """Filesystem layout (the reference's hard-coded cluster paths as
    explicit settings: dataset.py:22-23)."""

    data_folder: str = "./SID"
    train_list: str = ""  # default: <data_folder>/Sony_train_list.txt
    test_list: str = ""
    val_list: str = ""
    synthetic_folder: str = "./NoiseDiff_GeneratedNoiseData"
    resources_path: str = "./resources"
    pretrained_dir: str = "./pretrained_ckpts"
    eld_folder: str = "./ELD/testset"
    eld_val_list: str = ""
    eld_test_list: str = ""
    cache_dir: Optional[str] = None

    def __post_init__(self):
        if not self.train_list:
            self.train_list = os.path.join(self.data_folder, "Sony_train_list.txt")
        if not self.test_list:
            self.test_list = os.path.join(self.data_folder, "Sony_test_list.txt")
        if not self.val_list:
            self.val_list = os.path.join(self.data_folder, "Sony_val_list.txt")

    def long_dir(self) -> str:
        return os.path.join(self.data_folder, "Sony/long")

    def short_dir(self) -> str:
        return os.path.join(self.data_folder, "Sony/short")


class _EpochSeeded:
    """Per-(seed, epoch, index) RNG, so draws do not depend on the worker
    layout."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self._seed, self._epoch, idx]))


def iso_ratio_index(iso: int, ratio: float) -> int:
    """(iso, ratio) -> camera-embedding row (combination_mapping.pickle)."""
    idx = COMBINATION_MAPPING.get((int(iso), float(ratio)))
    if idx is None:
        raise KeyError(f"(iso={iso}, ratio={ratio}) not in the SID combination mapping")
    return idx


class SonyTrainDataset(_EpochSeeded):
    """Noise-pair training set with (iso, ratio) bucket rebalancing
    (dataset.py:29-145): buckets with 0 < n < 100 are replicated int(100/n)
    times; crops are biased 50% to the bottom rows (dataset.py:92-104).
    Each item's draws come from its (seed, epoch, index) generator, so the
    items equal the JAX package's on the same tree and seed."""

    def __init__(self, paths: DataPaths, crop_size: int, seed: int = 0):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size

        buckets: Dict[str, List[manifest.SidEntry]] = {}
        for e in manifest.parse_sid_list(paths.train_list):
            buckets.setdefault(f"{e.iso}_{int(e.ratio)}", []).append(e)

        samples: List[manifest.SidEntry] = []
        for entries in buckets.values():
            if 0 < len(entries) < 100:
                entries = int(100.0 / len(entries)) * entries
            samples.extend(entries)
        self.sample_list = samples

    def __len__(self) -> int:
        return len(self.sample_list)

    def _crop(self, rng, ih, iw):
        h = w = self.crop_size
        x = int(rng.integers(0, iw - w + 1))
        if rng.uniform() < 0.5:
            y = int(rng.integers(0, ih - h + 1))
        else:
            y = ih - h - 1  # bottom-row bias (dataset.py:97-99)
        return x, y

    def __getitem__(self, idx: int) -> dict:
        e = self.sample_list[idx]
        rng = self.rng(idx)
        bayer_in = open_bayer(os.path.join(self.paths.data_folder, e.in_path))
        bayer_gt = open_bayer(os.path.join(self.paths.data_folder, e.gt_path))
        ih, iw = bayer_in.shape[0] // 2, bayer_in.shape[1] // 2
        x, y = self._crop(rng, ih, iw)
        cs = self.crop_size
        noisy, clean, noise = native.make_noise_pair(bayer_in, bayer_gt, y, x, cs, cs,
                                                     float(e.ratio))
        coord = crop_coord_patch(ih, iw, y, x, cs, cs)
        return {
            "noise": noise,
            "iso": e.iso,
            "noisy_img": noisy,
            "clean_img": clean,
            "coord": coord.astype(np.float32),
            "iso_ratio_idx": iso_ratio_index(e.iso, e.ratio),
        }


class NoiseImageGenerationDataset(_EpochSeeded):
    """Clean-patch grid for bulk noise generation at one (iso, ratio)
    (dataset.py:152-281): excludes the clean frames seen in training for
    that pair, samples (30 - n_train) other clean frames, and walks the
    overlapping patch grid."""

    def __init__(self, paths: DataPaths, crop_size: int, iso_value: float, ratio_value: float,
                 seed: int = 0, max_train_pairs: int = 20, n_total_clean: int = 30,
                 frame_hw: Optional[Tuple[int, int]] = None):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size
        self.iso_value = int(iso_value)
        self.ratio_value = float(ratio_value)

        train = [
            e for e in manifest.parse_sid_list(paths.train_list)
            if e.iso == self.iso_value and e.ratio == self.ratio_value
        ]
        if len(train) >= max_train_pairs:
            raise RuntimeError(
                f"{len(train)} clean images for (ISO {self.iso_value}, ratio "
                f"{self.ratio_value}) >= {max_train_pairs} (reference dataset.py:187-189)"
            )

        # clean frames seen in training (dataset.py:160-161,191-194); a
        # missing pickle means the full pool
        seen: List[str] = []
        info_path = os.path.join(paths.pretrained_dir, "sid_train_clean_info.pickle")
        if os.path.exists(info_path):
            with open(info_path, "rb") as f:
                info = pickle.load(f)
            for key in (
                f"{self.iso_value}_{self.ratio_value}",
                f"{float(self.iso_value)}_{self.ratio_value}",
                f"{self.iso_value}_{int(self.ratio_value)}",
            ):
                if key in info:
                    seen = list(info[key])
                    break

        all_clean = sorted(os.listdir(paths.long_dir()))
        pool = [n for n in all_clean if n not in seen and ".ARW" in n]
        rng = np.random.default_rng(seed)
        k = min(max(n_total_clean - len(train), 0), len(pool))
        chosen = list(rng.choice(pool, size=k, replace=False)) if k else []
        self.gt_list = [os.path.join(paths.long_dir(), n) for n in chosen]

        # the packed frame size comes from the first clean frame
        if frame_hw is None and self.gt_list:
            h, w, _ = load_packed_frame(self.gt_list[0]).shape
            frame_hw = (h, w)
        self.frame_hw = frame_hw or (manifest.SID_PACKED_H, manifest.SID_PACKED_W)
        self.coord_list = manifest.patch_grid(*self.frame_hw, ps=crop_size)
        self.patch_per_img = len(self.coord_list)

    def __len__(self) -> int:
        return len(self.gt_list) * self.patch_per_img

    def __getitem__(self, idx: int) -> dict:
        gt_path = self.gt_list[idx // self.patch_per_img]
        x, y = self.coord_list[idx % self.patch_per_img]
        cs = self.crop_size
        gt_norm = load_packed_frame(gt_path)
        ih, iw, _ = gt_norm.shape
        coord = crop_coord_patch(ih, iw, y, x, cs, cs)
        return {
            "iso": self.iso_value,
            "ratio": self.ratio_value,
            "clean_img": gt_norm[y: y + cs, x: x + cs].astype(np.float32),
            "coord": coord.astype(np.float32),
            "clean_name": os.path.basename(gt_path),
            "iso_ratio_idx": iso_ratio_index(self.iso_value, self.ratio_value),
            "image_coord": f"{int(x)}_{int(y)}",
        }


class GenDarkFrameDataset(_EpochSeeded):
    """Coordinate-only grid for dark-frame generation (dataset.py:293-415):
    one representative pair per unique (iso, ratio); the trainer substitutes
    a zero clean image (trainer_diffusion.py:288-291)."""

    def __init__(self, paths: DataPaths, crop_size: int, seed: int = 0,
                 frame_hw: Optional[Tuple[int, int]] = None):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size
        seen = set()
        self.entries: List[manifest.SidEntry] = []
        for e in manifest.parse_sid_list(paths.train_list):
            key = f"{e.iso}_{int(e.ratio)}"
            if key not in seen:
                seen.add(key)
                self.entries.append(e)
        if frame_hw is None and self.entries:
            gt = os.path.join(paths.data_folder, self.entries[0].gt_path)
            h, w, _ = load_packed_frame(gt).shape
            frame_hw = (h, w)
        self.frame_hw = frame_hw or (manifest.SID_PACKED_H, manifest.SID_PACKED_W)
        self.coord_list = manifest.patch_grid(*self.frame_hw, ps=crop_size)
        self.patch_per_img = len(self.coord_list)

    def __len__(self) -> int:
        return len(self.entries) * self.patch_per_img

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx // self.patch_per_img]
        x, y = self.coord_list[idx % self.patch_per_img]
        cs = self.crop_size
        coord = crop_coord_patch(self.frame_hw[0], self.frame_hw[1], y, x, cs, cs)
        return {
            "iso": e.iso,
            "ratio": e.ratio,
            "coord": coord.astype(np.float32),
            "noisy_name": e.in_fn,
            "clean_name": e.gt_fn,
            "iso_ratio_idx": iso_ratio_index(e.iso, e.ratio),
            "image_coord": f"{int(x)}_{int(y)}",
        }


# ---------------------------------------------------------------------------
# Denoising-stage datasets
# ---------------------------------------------------------------------------


class SyntheticNoisDiffDenoisingDataset(_EpochSeeded):
    """Clean frames plus generated noise patches (dataset_denoising.py:29-168).

    <synthetic_folder>/ISO{iso}_Ratio{ratio}/'clean+noisy+x_y.npy' holds
    the noise the generation CLI wrote (CHW, or HWC) at packed (x, y) of
    the clean frame <data_folder>/Sony/long/clean*; the clean frames come
    through a PackedFrameCache (memmaps under cache_dir when set) in place
    of the reference's RAM preload. With sub_darkshading the noisy patch
    loses the PMN dark shading of its ISO at its place in the frame."""

    def __init__(self, paths: DataPaths, crop_size: int, sub_darkshading: bool = False,
                 seed: int = 0):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size
        self.sub_darkshading = sub_darkshading
        self.cache = PackedFrameCache(paths.cache_dir)
        self.darkshading = Darkshading(paths.resources_path) if sub_darkshading else None

        self.clean_paths = {
            os.path.basename(p).split(".ARW")[0].split(".npy")[0]: p
            for p in sorted(glob.glob(os.path.join(paths.long_dir(), "*")))
            if ".ARW" in p or p.endswith(".npy")
        }
        pair_list = []
        for subfolder in sorted(os.listdir(paths.synthetic_folder)):
            full = os.path.join(paths.synthetic_folder, subfolder)
            if not os.path.isdir(full):
                continue
            iso_value, ratio_value = manifest.parse_synthetic_folder_name(subfolder)
            for noise_path in sorted(glob.glob(os.path.join(full, "*.npy"))):
                clean, _noisy, x, y = manifest.parse_npy_patch_name(os.path.basename(noise_path))
                pair_list.append((clean, noise_path, x, y, iso_value, ratio_value))
        self.pair_list = pair_list

    def __len__(self) -> int:
        return len(self.pair_list)

    def _remove_darkshading(self, noisy_hwc, iso, ratio, x, y):
        """HWC mirror of dataset_denoising.py:80-118."""
        ph, pw = noisy_hwc.shape[:2]
        bayer = np_unpack_bayer(noisy_hwc)
        bayer = bayer / ratio
        bayer = np.clip(bayer * SCALE + 512.0, 0.0, 16383.0)
        ds = self.darkshading.get(iso)
        bx, by = 2 * x, 2 * y
        bayer = bayer - ds[by: by + 2 * ph, bx: bx + 2 * pw]
        out = np_pack_bayer(bayer)
        out = np.maximum(out - 512.0, 0.0) / SCALE
        return np.clip(out * ratio, 0.0, 1.0)

    def __getitem__(self, idx: int) -> dict:
        clean_name, noise_path, x, y, iso, ratio = self.pair_list[idx]
        rng = self.rng(idx)

        noise = np.load(noise_path)
        if noise.ndim == 3 and noise.shape[0] == 4:  # the generation CLI's CHW export
            noise = noise.transpose(1, 2, 0)
        noise = np.clip(noise, -1.0, 1.0).astype(np.float32)

        # the patch size is the npy's own (512 in the shipped pipeline,
        # which dataset_denoising.py:137 hard-codes)
        ph, pw = noise.shape[:2]
        clean_full = self.cache.get(self.clean_paths[clean_name])
        clean = np.asarray(clean_full[y: y + ph, x: x + pw], np.float32)
        noisy = np.clip(noise + clean, 0.0, 1.0)
        clean = np.clip(clean, 0.0, 1.0)

        if self.sub_darkshading:
            noisy = self._remove_darkshading(noisy, iso, ratio, x, y)
        noisy = np.clip(noisy, 0.0, 1.0).astype(np.float32)

        # random even-aligned crop (dataset_denoising.py:120-130)
        cs = self.crop_size
        ih, iw = noisy.shape[:2]
        cx = int(rng.integers(0, iw - cs + 1)) // 2 * 2
        cy = int(rng.integers(0, ih - cs + 1)) // 2 * 2
        return {
            "noisy_img": noisy[cy: cy + cs, cx: cx + cs],
            "clean_img": clean[cy: cy + cs, cx: cx + cs],
            "iso": iso,
            "ratio": ratio,
        }


class RealSonyDenoisingDataset(_EpochSeeded):
    """Real short/long SID pairs (dataset_denoising.py:172-265): the noisy
    frame stays in DN through the optional darkshading subtraction, then is
    multiplied by the ratio, clipped to [0, white - black] and normalised."""

    def __init__(self, paths: DataPaths, crop_size: int, sub_darkshading: bool = False,
                 seed: int = 0):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size
        self.sub_darkshading = sub_darkshading
        self.entries = manifest.parse_sid_list(paths.train_list)
        self.darkshading = Darkshading(paths.resources_path)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx]
        rng = self.rng(idx)
        clean = load_packed_frame(os.path.join(self.paths.data_folder, e.gt_path), rescale=True)
        noisy = load_packed_frame(os.path.join(self.paths.data_folder, e.in_path),
                                  rescale=False)

        cs = self.crop_size
        ih, iw = noisy.shape[:2]
        x = int(rng.integers(0, iw - cs + 1)) // 2 * 2
        y = int(rng.integers(0, ih - cs + 1)) // 2 * 2
        clean = clean[y: y + cs, x: x + cs]
        noisy = noisy[y: y + cs, x: x + cs]

        if self.sub_darkshading:
            ds = np_pack_bayer(self.darkshading.get(e.iso))
            noisy = noisy - ds[y: y + cs, x: x + cs]

        noisy = np.clip(noisy * e.ratio, 0.0, SCALE) / SCALE
        return {
            "noisy_img": noisy.astype(np.float32),
            "clean_img": clean.astype(np.float32),
            "iso": e.iso,
            "ratio": e.ratio,
        }


def _truncnorm(rng: np.random.Generator, mean, var, lo, hi):
    """Rejection-sampled truncated normal (in place of scipy.stats.truncnorm,
    dataset_denoising.py:323-329; the +-30% window makes rejection cheap)."""
    std = np.sqrt(var)
    for _ in range(1000):
        v = rng.normal(mean, std)
        if lo <= v <= hi:
            return v
    return float(np.clip(rng.normal(mean, std), lo, hi))


class PossionGaussianDenoisingDataset(_EpochSeeded):
    """The classical Poisson-Gaussian baseline (dataset_denoising.py:271-372):
    per-ISO (K, VAR) from <pretrained_dir>/noise_profile_all.pkl, each
    jittered within +-30% by a truncated normal. Items carry no iso or
    ratio."""

    def __init__(self, paths: DataPaths, crop_size: int, seed: int = 0):
        super().__init__(seed)
        self.paths = paths
        self.crop_size = crop_size
        self.entries = manifest.parse_sid_list(paths.train_list)
        with open(os.path.join(paths.pretrained_dir, "noise_profile_all.pkl"), "rb") as f:
            self.noise_profile = pickle.load(f)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx]
        rng = self.rng(idx)
        clean = load_packed_frame(os.path.join(self.paths.data_folder, e.gt_path), rescale=False)
        cs = self.crop_size
        ih, iw = clean.shape[:2]
        x = int(rng.integers(0, iw - cs + 1)) // 2 * 2
        y = int(rng.integers(0, ih - cs + 1)) // 2 * 2
        clean = clean[y: y + cs, x: x + cs]

        K, VAR = self.noise_profile[e.iso]
        k = _truncnorm(rng, K, 1.0, 0.7 * K, 1.3 * K)
        var = _truncnorm(rng, VAR, 1.0, 0.7 * VAR, 1.3 * VAR)
        latent = clean / float(e.ratio)
        poisson = k * rng.poisson(np.maximum(latent / k, 0.0)).astype(np.float32)
        gaussian = rng.normal(0.0, np.sqrt(var), clean.shape).astype(np.float32)
        noisy = np.clip((poisson + gaussian) * e.ratio, 0.0, SCALE)
        return {
            "clean_img": (clean / SCALE).astype(np.float32),
            "noisy_img": (noisy / SCALE).astype(np.float32),
        }


DATASETS = {
    "SonyTrainDataset": SonyTrainDataset,
    "NoiseImageGenerationDataset": NoiseImageGenerationDataset,
    "GenDarkFrameDataset": GenDarkFrameDataset,
    "SyntheticNoisDiffDenoisingDataset": SyntheticNoisDiffDenoisingDataset,
    "RealSonyDenoisingDataset": RealSonyDenoisingDataset,
    "PossionGaussianDenoisingDataset": PossionGaussianDenoisingDataset,
}
