"""Noise-realism evaluation: the KLD between real and generated noise
histograms.

Port of noisediff_tpu/cli/eval_kld.py (the reference ships the KLD helpers,
utils/util.py:188-256, without a harness): it rebuilds the real residual
noise clip(pack(short) * ratio) - pack(long) of one (ISO, ratio) from the
SID training list, loads the generated `.npy` patches of the same setting,
and prints the forward, inverse and symmetric KLD as one JSON line. Host
numpy throughout; frames are packed with the arithmetic of the JAX
package's native packer (`raw_host.load_packed_frame`), so both CLIs bin
the same values.

  python -m noisediff_tpu_torch.cli.eval_kld --iso 800 --ratio 250 \
    --generated ./output/gen/ISO800_Ratio250/npy/generated --sid_folder /data/SID
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..config import add_path_flags, paths_from_args
from ..data import manifest
from ..data.raw_host import load_packed_frame
from ..ops.metrics import get_histogram, kl_div_3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Noise-realism KLD eval")
    p.add_argument("--iso", type=int, required=True)
    p.add_argument("--ratio", type=float, required=True)
    p.add_argument("--generated", type=str, required=True,
                   help="folder of generated noise .npy patches")
    p.add_argument("--n_bins", type=int, default=1000)
    p.add_argument("--left_edge", type=float, default=-0.1)
    p.add_argument("--right_edge", type=float, default=0.1)
    p.add_argument("--max_pairs", type=int, default=10)
    p.add_argument("--max_patches", type=int, default=200)
    p.add_argument("--out", type=str, default="",
                   help="also write the result JSON to this path")
    add_path_flags(p)
    return p


def real_noise_samples(paths, iso: int, ratio: float, max_pairs: int) -> np.ndarray:
    """The residual noise of the first max_pairs SID training pairs at
    (iso, ratio), flattened."""
    chunks = []
    for e in manifest.parse_sid_list(paths.train_list):
        if e.iso == iso and e.ratio == ratio:
            noisy = np.clip(load_packed_frame(os.path.join(paths.data_folder, e.in_path))
                            * e.ratio, 0.0, 1.0)
            clean = load_packed_frame(os.path.join(paths.data_folder, e.gt_path))
            chunks.append((noisy - clean).ravel())
            if len(chunks) >= max_pairs:
                break
    if not chunks:
        raise RuntimeError(f"no SID pairs for ISO {iso} ratio {ratio}")
    return np.concatenate(chunks)


def generated_noise_samples(folder: str, max_patches: int) -> np.ndarray:
    """The first max_patches generated patches of a folder, by name, flattened."""
    files = sorted(glob.glob(os.path.join(folder, "*.npy")))[:max_patches]
    if not files:
        raise RuntimeError(f"no generated .npy in {folder}")
    return np.concatenate([np.load(f).ravel() for f in files])


def main(argv=None) -> dict:
    """Print (and return) {'iso', 'ratio', 'kld_forward', 'kld_inverse',
    'kld_symmetric', 'n_real', 'n_synth'}."""
    args = build_parser().parse_args(argv)
    paths = paths_from_args(args)

    real = real_noise_samples(paths, args.iso, args.ratio, args.max_pairs)
    synth = generated_noise_samples(args.generated, args.max_patches)

    edges = np.linspace(args.left_edge, args.right_edge, args.n_bins + 1)
    edges = np.concatenate([[-1000.0], edges, [1000.0]])
    p, _ = get_histogram(real, bin_edges=edges)
    q, _ = get_histogram(synth, bin_edges=edges)
    fwd, inv, sym = kl_div_3(p, q)
    result = {
        "iso": args.iso, "ratio": args.ratio,
        "kld_forward": fwd, "kld_inverse": inv, "kld_symmetric": sym,
        "n_real": int(real.size), "n_synth": int(synth.size),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
