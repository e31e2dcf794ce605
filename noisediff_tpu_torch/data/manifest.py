"""SID / ELD manifest parsing and the generation patch grid.

Port of noisediff_tpu/data/manifest.py:
  * Sony_train_list.txt lines 'in gt ISOxxx Fx.x', exposure from filename
    chars [9:-5], ratio = min(gt_expo / in_expo, 300) (reference
    dataloader/dataset.py:48-64);
  * the overlapping patch grid, step = ps - ps//4 over the packed frame
    (dataset.py:203-219) — its (x, y) order is load-bearing for the
    'clean+noisy+x_y.npy' names the denoising stage reads;
  * that cross-stage filename contract itself (`npy_patch_name`, written by
    the generation trainer, parsed by the denoising dataset) and the
    'ISO800_Ratio250' folder names of the generated data;
  * the unique (ISO, ratio) pairs of a list (util.py:150-181);
  * the ELD evaluation lists, joined with ISO and ratio from the SID lists
    by input filename (test_denoising.py:143-172), and the ELD test set's
    scene layout (test_denoising.py:444-459, 490-498).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np

# packed (half-res) SID Sony frame size (dataset.py:203)
SID_PACKED_W = 4256 // 2
SID_PACKED_H = 2848 // 2

RATIO_CAP = 300.0


@dataclasses.dataclass(frozen=True)
class SidEntry:
    in_path: str
    gt_path: str
    iso: int
    ratio: float

    @property
    def in_fn(self) -> str:
        return os.path.basename(self.in_path)

    @property
    def gt_fn(self) -> str:
        return os.path.basename(self.gt_path)


def exposure_from_filename(fn: str) -> float:
    """'00001_00_0.04s.ARW' -> 0.04 (chars [9:-5], reference dataset.py:57-58)."""
    return float(fn[9:-5])


def parse_sid_line(line: str) -> SidEntry:
    in_path, gt_path, iso_s, _f = line.split(" ")
    iso = int(iso_s.replace("ISO", ""))
    in_expo = exposure_from_filename(os.path.basename(in_path))
    gt_expo = exposure_from_filename(os.path.basename(gt_path))
    ratio = min(gt_expo / in_expo, RATIO_CAP)
    return SidEntry(in_path=in_path, gt_path=gt_path, iso=iso, ratio=ratio)


def parse_sid_list(path: str) -> List[SidEntry]:
    entries = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(parse_sid_line(line))
    return entries


def get_iso_ratio_info(entries: Iterable[SidEntry]) -> np.ndarray:
    """Unique (iso, ratio) pairs, sorted, float64 (reference util.py:150-181)."""
    pairs = sorted({(e.iso, e.ratio) for e in entries})
    return np.asarray(pairs, dtype=np.float64)


def patch_grid(
    h: int = SID_PACKED_H, w: int = SID_PACKED_W, ps: int = 512
) -> List[Tuple[int, int]]:
    """Overlapping (x, y) patch origins, y-major order (dataset.py:203-219).

    A trailing origin at (dim - ps) is appended when the remainder is under
    one patch, exactly like the reference — including the possible
    duplicate when (dim - ps) is already on the grid."""
    step = ps - ps // 4
    thresh = ps
    h_space = np.arange(0, h - ps + 1, step)
    if h - (h_space[-1] + ps) < thresh:
        h_space = np.append(h_space, h - ps)
    w_space = np.arange(0, w - ps + 1, step)
    if w - (w_space[-1] + ps) < thresh:
        w_space = np.append(w_space, w - ps)
    return [(int(x), int(y)) for y in h_space for x in w_space]


def npy_patch_name(clean_name: str, noisy_name: str, x: int, y: int) -> str:
    """'clean+noisy+x_y.npy' cross-stage filename contract
    (trainer_diffusion.py:308-317 / dataset_denoising.py:58-61)."""
    clean = clean_name.split(".ARW")[0]
    noisy = noisy_name.split(".ARW")[0]
    return f"{clean}+{noisy}+{int(x)}_{int(y)}.npy"


def parse_npy_patch_name(name: str) -> Tuple[str, str, int, int]:
    """'clean+noisy+x_y.npy' -> (clean, noisy, x, y)."""
    stem = name[:-4] if name.endswith(".npy") else name
    clean, noisy, coord = stem.split("+")
    x, y = coord.split("_")
    return clean, noisy, int(x), int(y)


def parse_synthetic_folder_name(subfolder: str) -> Tuple[int, int]:
    """'ISO800_Ratio250' -> (800, 250) (dataset_denoising.py:47-52)."""
    iso_s, ratio_s = subfolder.split("_")
    return int(iso_s.replace("ISO", "")), int(ratio_s.replace("Ratio", ""))


def parse_eld_list(path: str) -> List[Tuple[str, str]]:
    """ELD list lines 'in_path gt_path' -> (in filename, gt filename)
    (test_denoising.py:143-157)."""
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                in_path, gt_path = line.split(" ")
                out.append((os.path.basename(in_path), os.path.basename(gt_path)))
    return out


def eld_list_with_iso(sid_list_path: str,
                      eld_list_path: str) -> List[Tuple[str, str, int, float]]:
    """The ELD list's pairs with ISO and ratio looked up in the SID list by
    input filename (test_denoising.py:159-172)."""
    by_in_fn = {e.in_fn: e for e in parse_sid_list(sid_list_path)}
    out = []
    for in_fn, gt_fn in parse_eld_list(eld_list_path):
        e = by_in_fn[in_fn]
        out.append((in_fn, gt_fn, e.iso, e.ratio))
    return out


def eld_scene_paths(eld_folder: str, ratio: int, cameras: Sequence[str] = ("SonyA7S2",),
                    suffix: str = ".ARW",
                    scenes: Sequence[int] = tuple(range(1, 11))) -> List[Tuple[str, str]]:
    """(input, ground truth) paths of the ELD test set: scenes 1-10 of each
    camera, the image ids by ratio (test_denoising.py:444-459, 490-498);
    ratios other than 100 and 200 raise NotImplementedError."""
    if ratio == 100:
        img_ids, gt_ids = [4, 9, 14], [6, 11, 16]
    elif ratio == 200:
        img_ids, gt_ids = [5, 10, 15], [6, 11, 16]
    else:
        raise NotImplementedError(f"ELD ratio {ratio} not supported")
    pairs = []
    for camera in cameras:
        for scene_id in scenes:
            datadir = os.path.join(eld_folder, camera, f"scene-{scene_id}")
            for img_id, gt_id in zip(img_ids, gt_ids):
                pairs.append((os.path.join(datadir, f"IMG_{img_id:04d}{suffix}"),
                              os.path.join(datadir, f"IMG_{gt_id:04d}{suffix}")))
    return pairs
