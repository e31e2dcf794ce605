"""Diffusion testing CLI — bulk noise-data generation on the GPU.

Port of noisediff_tpu/cli/test_diffusion.py: the same flags and defaults
(reference test_diffusion.py:22-114), plus --device (default cuda). Run as

  python -m noisediff_tpu_torch.cli.test_diffusion --name ISO800Ratio250 \
    --resume <ckpt.pth> --generation_result noise \
    --testset NoiseImageGenerationDataset --save_npy --random_seed 0 \
    --beta_schedule sigmoid2 --batch_size 4 --net_name NoiseDiffNet \
    --positional_encoding --dim 48 --crop_size 512 --with_camera_settings \
    --sampler dpm --save_folder ./output/... --iso 800 --ratio 250

('--iso 800 --ratio 250' reach --iso_value/--ratio_value through argparse
prefix abbreviation, as in the reference's script.sh:10.) Under torchrun
with `--launcher pytorch` each rank generates its strided shard of the
patch grid and writes its own, disjoint, set of patches.
"""
from __future__ import annotations

import argparse
import os

from ..config import add_path_flags
from ..parallel import mesh
from .common import add_device_flags, init_distributed, print_args, set_random_seed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="NoiseDiff generation (PyTorch/CUDA)")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--name", default="test_diffusion", type=str)
    parser.add_argument("--phase", default="test", type=str)

    add_device_flags(parser)

    ## estimation
    parser.add_argument("--visualize_img", action="store_true")
    parser.add_argument("--visualize_noise", action="store_true")
    parser.add_argument("--save_npy", action="store_true")
    parser.add_argument("--skip_existing", action="store_true",
                        help="resume bulk generation: skip batches whose npy outputs "
                             "already exist (missing batches regenerate identically "
                             "from their per-batch generator)")
    parser.add_argument("--with_camera_settings", action="store_true")
    parser.add_argument("--beta_schedule", default="sigmoid", type=str)
    parser.add_argument("--temperature", default=0.1, type=float)
    parser.add_argument("--positional_encoding", action="store_true")
    parser.add_argument("--normalize_condition", action="store_true")

    ## network setting
    parser.add_argument("--net_name", default="NoiseDiffNet", type=str)
    parser.add_argument("--dim", default=64, type=int)
    parser.add_argument("--inp_dim", default=4, type=int)
    parser.add_argument("--cond_dim", default=4, type=int)

    ## diffusion setting
    parser.add_argument("--diffusion_steps", default=1000, type=int)
    parser.add_argument("--generation_result", default="noise", type=str)
    parser.add_argument("--self_condition", action="store_true")
    parser.add_argument("--auto_normalize", action="store_true")
    parser.add_argument("--diffusion_objective", default="pred_v", type=str)
    parser.add_argument("--dark_frame", action="store_true")
    parser.add_argument("--sampling_timesteps", default=None, type=int,
                        help="enable DDIM with this many steps")
    parser.add_argument("--sampler", default="auto", type=str,
                        choices=("auto", "ddpm", "ddim", "dpm"),
                        help="auto | ddpm | ddim | dpm (DPM-Solver++ 2M)")
    parser.add_argument("--dpm_spacing", default="lambda", type=str,
                        choices=("time", "lambda"),
                        help="DPM-Solver step grid: 'lambda' (uniform in log-SNR, the "
                             "production default) or 'time' (uniform in t)")

    ## dataloader setting
    add_path_flags(parser)
    parser.add_argument("--testset", default="NoiseImageGenerationDataset", type=str)
    parser.add_argument("--crop_size", default=256, type=int)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--iso_value", default=250, type=float)
    parser.add_argument("--ratio_value", default=100, type=float)
    parser.add_argument("--clean_source", default="SID", type=str)

    parser.add_argument("--resume", default=".", type=str)
    parser.add_argument("--save_folder", default="./output/generated_data/noise_imgs_SID_DDPM",
                        type=str)
    return parser


def main(argv=None, fused_tail: bool = True):
    """Run generation; returns the trainer's summary of the run.
    `fused_tail=False` (Python callers only) samples DDIM unfused."""
    args = build_parser().parse_args(argv)
    set_random_seed(args.random_seed)
    init_distributed(args)
    try:
        args.save_folder = os.path.join(args.save_folder, args.name)
        os.makedirs(args.save_folder, exist_ok=True)
        print_args(args)

        from ..train.trainer_diffusion import Trainer

        trainer = Trainer(args)
        trainer.fused_tail = fused_tail
        return trainer.test()
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
