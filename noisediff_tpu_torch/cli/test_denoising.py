"""Denoiser evaluation CLI: PSNR / SSIM of LSID on the SID or ELD test
frames, on the GPU.

Port of noisediff_tpu/cli/test_denoising.py (reference `test_denoising.py`,
main :364-516, helpers :59-361): the same flags, plus --device (default
cuda; pass --device cpu to run without a GPU). Run as

  python -m noisediff_tpu_torch.cli.test_denoising --resume <net_final.pth> \
    --ratio 250 --correct_darkshading --correct_illum --sid_folder <SID> \
    --resources_path <PMN resources> --save_folder <out>

The file list is the SID val and test lists joined with the ELD lists by
input filename (or, where those are absent, the whole SID test list),
filtered by --ratio; --test_dataset ELD walks the ELD test set's scenes
with the ISO from each file's EXIF or `.meta.json` sidecar. LSID runs in
fp32 (TF32 off), with weights from a `.pth`/`.pt` or a JAX `.npz`
snapshot. Each frame is decoded on the host; the card packs it (with the
dark shading subtracted under --correct_darkshading), multiplies it by the
ratio, clips, runs the forward, clips, applies the illuminance correction
under --correct_illum and computes PSNR and SSIM; only those two numbers
come back. --visualize_img writes each output as a PNG: LibRaw's
postprocess where rawpy is installed and the raw file is present, else an
R, (G1 + G2) / 2, B preview; both through PIL, which it then needs.
`--launcher pytorch` joins the process group (on its card) as the JAX CLI
does, and every rank evaluates every frame: the JAX CLI shards no frames.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import add_path_flags, paths_from_args
from ..parallel import mesh
from .common import (
    add_device_flags, init_distributed, print_args, resolve_device, set_random_seed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Denoising eval (PyTorch/CUDA)")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--phase", default="test", type=str)

    add_device_flags(parser)

    ## estimation
    parser.add_argument("--noise_param_estm", action="store_true")
    parser.add_argument("--visualize_img", action="store_true")
    parser.add_argument("--correct_illum", action="store_true")
    parser.add_argument("--correct_darkshading", action="store_true")

    ## network setting
    parser.add_argument("--net_name", default="LSID", type=str)
    parser.add_argument("--dim", default=48, type=int)
    parser.add_argument("--lsid_width", default=32, type=int,
                        help="LSID level-1 width (extension; 32 = reference)")
    parser.add_argument("--inp_dim", default=4, type=int)
    parser.add_argument("--cond_dim", default=4, type=int)

    ## dataloader setting
    parser.add_argument("--iso", type=int, default=250)
    parser.add_argument("--ratio", type=int, default=300)
    parser.add_argument("--test_dataset", default="SID", type=str, help="SID | ELD")
    add_path_flags(parser)

    parser.add_argument("--resume", default="", type=str,
                        help="LSID weights: a .pth/.pt or a JAX .npz snapshot")
    parser.add_argument("--save_folder",
                        default="../logs/denoising/inference_withdarkshading", type=str)
    return parser


def frame_list(args, paths) -> List[tuple]:
    """(input path, ground-truth path, iso, ratio) of every frame to
    evaluate, in the JAX CLI's order (test_denoising.py:77-111)."""
    from ..data import manifest
    from ..data.raw_host import metainfo

    if args.test_dataset == "SID":
        eld_val = args.eld_val_list or os.path.join(paths.data_folder, "ELD_Sony_val.txt")
        eld_test = args.eld_test_list or os.path.join(paths.data_folder, "ELD_Sony_test.txt")
        input_list = []
        for sid_list, eld_list in ((paths.val_list, eld_val), (paths.test_list, eld_test)):
            if os.path.exists(eld_list) and os.path.exists(sid_list):
                input_list += manifest.eld_list_with_iso(sid_list, eld_list)
        if not input_list and os.path.exists(paths.test_list):
            # the whole SID test list where the ELD sublists are not beside it
            input_list = [(e.in_fn, e.gt_fn, e.iso, e.ratio)
                          for e in manifest.parse_sid_list(paths.test_list)]
        return [(os.path.join(paths.short_dir(), in_fn), os.path.join(paths.long_dir(), gt_fn),
                 iso, ratio) for (in_fn, gt_fn, iso, ratio) in input_list if ratio == args.ratio]
    if args.test_dataset == "ELD":
        return [(in_path, gt_path, metainfo(in_path)[0], args.ratio)
                for in_path, gt_path in manifest.eld_scene_paths(paths.eld_folder, args.ratio)]
    raise NotImplementedError(args.test_dataset)


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def evaluate(args, keep: int = 0) -> Dict[str, object]:
    """Evaluate every frame of the test list; returns {'PSNR': mean, 'SSIM':
    mean, 'n': frames}, and beside them 'frames' (each frame's paths, PSNR,
    SSIM and the seconds of its parts: 'decode_s', the host's decode of
    both mosaics (and of the ISO's dark shading, the first time), on the
    host clock; on the device's (CUDA events on the card) 'upload_s', the
    mosaics pinned and copied, 'forward_s', packing and the forward, and
    'metrics_s', the illuminance correction, PSNR and SSIM; on the host
    clock again 'visual_s', the PNG's download and write under
    --visualize_img, and 'frame_s', the whole frame), 'seconds' (the loop's
    wall time) and, with keep > 0, 'outputs': the first `keep` output
    frames as (H, W, 4) float32 arrays."""
    from ..data.raw_host import Darkshading, decode_bayer
    from ..models import define_network
    from ..ops import metrics as M
    from ..ops import raw as raw_ops
    from ..train.trainer_diffusion import _DeviceClock
    from ..weights import load_into
    from .common import set_precision_flags

    dev = resolve_device(getattr(args, "device", "cuda"))
    set_precision_flags()
    paths = paths_from_args(args)
    pairs = frame_list(args, paths)

    # fp32, as the JAX CLI builds it (dtype=None)
    model = define_network(args.net_name, args, dtype=None)
    if args.resume:
        load_into(model, args.resume)  # a .pth/.pt or a JAX .npz snapshot, strict
    model = model.to(dev, memory_format=torch.channels_last).eval()
    darkshading = Darkshading(paths.resources_path) if args.correct_darkshading else None
    maps: Dict[int, torch.Tensor] = {}  # the dark shading of each ISO, float32 on dev

    clock = _DeviceClock(dev)
    ratio = float(args.ratio)
    frames: List[dict] = []
    outputs: List[np.ndarray] = []
    t_loop = time.perf_counter()
    for in_path, gt_path, iso, _ in pairs:
        t0 = time.perf_counter()
        bayer_in = decode_bayer(in_path)
        bayer_gt = decode_bayer(gt_path)
        ds = None
        if darkshading is not None and int(iso) not in maps:
            # float32, as the JAX package takes it (jnp.asarray of a float64 map)
            ds = np.asarray(darkshading.get(int(iso)), np.float32)
        decode_s = time.perf_counter() - t0

        m0 = clock.mark()
        x_in, x_gt = _upload(bayer_in, dev), _upload(bayer_gt, dev)
        if ds is not None:
            maps[int(iso)] = _upload(ds, dev)
        m1 = clock.mark()
        with torch.no_grad():
            if darkshading is not None:
                noisy = raw_ops.pack_raw_withdarkshading(x_in, maps[int(iso)], ratio) * ratio
            else:
                noisy = raw_ops.pack_raw(x_in) * ratio
            noisy = noisy.clamp(0.0, 1.0)
            clean = raw_ops.pack_raw(x_gt).clamp(0.0, 1.0)
            out = model(noisy[None])[0].clamp(0.0, 1.0)
            m2 = clock.mark()
            if args.correct_illum:
                out = M.illuminance_correct(out, clean)
            p, s = M.psnr(out, clean, 1.0), M.ssim(out, clean, 1.0)
            m3 = clock.mark()
        frame = {"in_path": in_path, "gt_path": gt_path, "PSNR": float(p), "SSIM": float(s),
                 "decode_s": decode_s, "upload_s": clock.seconds(m0, m1),
                 "forward_s": clock.seconds(m1, m2), "metrics_s": clock.seconds(m2, m3)}
        print(f"Current PSNR: {frame['PSNR']}, SSIM: {frame['SSIM']}")
        if len(outputs) < keep:
            outputs.append(out.cpu().numpy())
        t1 = time.perf_counter()
        if args.visualize_img:
            _save_visual(args, in_path, gt_path, out.cpu().numpy())
        frame["visual_s"] = time.perf_counter() - t1
        frame["frame_s"] = time.perf_counter() - t0
        frames.append(frame)
    seconds = time.perf_counter() - t_loop

    psnrs = [f["PSNR"] for f in frames]
    ssims = [f["SSIM"] for f in frames]
    mean_psnr = float(np.mean(psnrs)) if psnrs else float("nan")
    mean_ssim = float(np.mean(ssims)) if ssims else float("nan")
    print(f"===> Averaged PSNR: {mean_psnr}, SSIM:{mean_ssim}")
    result = {"PSNR": mean_psnr, "SSIM": mean_ssim, "n": len(frames), "frames": frames,
              "seconds": seconds}
    if keep:
        result["outputs"] = outputs
    return result


def _save_visual(args, in_path: str, gt_path: str, out_hwc4: np.ndarray) -> str:
    """The PNG of one output frame, as the JAX CLI writes it: with rawpy
    and the raw ground-truth file present, postprocess_bayer
    (test_denoising.py:267-298: the 4 channels written back into the raw
    buffer by raw_pattern, LibRaw postprocess with the camera white
    balance, half size); otherwise the R, (G1 + G2) / 2, B preview. Returns
    the file's path; raises where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("--visualize_img writes PNGs through PIL (Pillow), which is not "
                          "installed") from exc
    if args.test_dataset == "ELD":
        scene_name, image_name = in_path.split("/")[-2:]
        image_name = scene_name + "_" + image_name.split(".ARW")[0]
    else:
        image_name = os.path.basename(in_path).split(".ARW")[0].split(".npy")[0]
    out_file = os.path.join(args.save_folder, f"{image_name}_output.png")
    os.makedirs(args.save_folder, exist_ok=True)
    try:
        import rawpy  # type: ignore
    except ImportError:
        rawpy = None
    if rawpy is not None and os.path.isfile(gt_path):
        raw = rawpy.imread(gt_path)
        pattern = raw.raw_pattern
        bl = np.array(raw.black_level_per_channel)[:, None, None]
        img = np.clip(out_hwc4, 0, 1).transpose(2, 0, 1)
        img = img * (16383 - bl) + bl
        vis = raw.raw_image_visible
        h, w = vis.shape
        locs = {int(pattern[r, c]): (r, c) for r in range(2) for c in range(2)}
        for ch, code in enumerate((0, 1, 2, 3)):  # R, G1, B, G2
            r, c = locs[code]
            vis[r:h:2, c:w:2] = img[ch]
        rgb = raw.postprocess(use_camera_wb=True, half_size=True, no_auto_bright=True,
                              output_bps=8)
        Image.fromarray(rgb.astype(np.uint8)).save(out_file)
    else:
        rgb = np.stack([out_hwc4[..., 0], 0.5 * (out_hwc4[..., 1] + out_hwc4[..., 3]),
                        out_hwc4[..., 2]], axis=-1)
        Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(out_file)
    return out_file


def main(argv=None):
    """Evaluate; returns `evaluate`'s result."""
    args = build_parser().parse_args(argv)
    set_random_seed(args.random_seed)
    resolve_device(args.device)
    init_distributed(args)
    try:
        if args.visualize_img:
            os.makedirs(args.save_folder, exist_ok=True)
        print_args(args)
        return evaluate(args)
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
