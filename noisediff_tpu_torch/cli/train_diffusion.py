"""Diffusion training CLI — trains NoiseDiffNet on the GPU.

Port of noisediff_tpu/cli/train_diffusion.py: the same flags and defaults
(reference train_diffusion.py:33-160), plus --device (default cuda; pass
--device cpu to run without a GPU). The canonical run (script.sh:8):

  python -m noisediff_tpu_torch.cli.train_diffusion --use_tb_logger \
    --save_epoch_freq 10 --generation_result noise --name train_diffusion \
    --net_name NoiseDiffNet --beta_schedule sigmoid2 --positional_encoding \
    --trainset SonyTrainDataset --dim 48 --crop_size 512 \
    --with_camera_settings --batch_size 4 --max_iter 500 \
    --save_folder ./logs/noise_synthesis_newstart/weights

bf16 compute over fp32 parameters (--no_mixed_precision for fp32).
Snapshots go to <save_folder>/<name>/snapshot as {net,ema,optimizer_G}_*.pth.
--resume takes a .pth/.pt or a JAX .npz snapshot, or 'auto' (the newest
snapshot of this run); --resume_optim an optimizer_G .pth or a JAX .npz.
--remat recomputes the ResnetBlocks in the backward (less device memory for
a larger batch or crop); --profile writes a torch.profiler trace of steps
5-9 under <save_folder>/<name>/profile. Flags the JAX trainer ignores are
accepted and ignored. Under torchrun (one process per card):

  torchrun --nproc_per_node 2 -m noisediff_tpu_torch.cli.train_diffusion \
    --launcher pytorch ... --batch_size 8

trains data-parallel over NCCL with a global batch of 8 (4 per card); rank 0
logs and saves the snapshots.
"""
from __future__ import annotations

import argparse

from ..config import add_path_flags
from ..parallel import mesh
from .common import add_device_flags, init_distributed, set_random_seed, setup_run_dirs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Noise Synthesis Training (PyTorch/CUDA)")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--name", default="train_diffusion", type=str)
    parser.add_argument("--phase", default="train", type=str)

    ## device setting
    add_device_flags(parser)

    ## network setting
    parser.add_argument("--net_name", default="UNetAttn", type=str,
                        help="NoiseDiffNet | UNet_PosEmbV2 | ...")
    parser.add_argument("--inp_dim", default=4, type=int)
    parser.add_argument("--cond_dim", default=4, type=int)
    parser.add_argument("--dim", default=64, type=int)
    parser.add_argument("--with_camera_settings", action="store_true")
    parser.add_argument("--iso_value", default=250, type=float)
    parser.add_argument("--ratio_value", default=100, type=float)

    ## diffusion setting
    parser.add_argument("--diffusion_steps", default=1000, type=int)
    parser.add_argument("--generation_result", default="noise", type=str, help="noise | image")
    parser.add_argument("--self_condition", action="store_true")
    parser.add_argument("--auto_normalize", action="store_true")
    parser.add_argument("--normalize_condition", action="store_true")
    parser.add_argument("--positional_encoding", action="store_true")
    parser.add_argument("--scale_noise", action="store_true")
    parser.add_argument("--temperature", default=0.1, type=float)
    parser.add_argument("--loss_weight_scheme", default="None", type=str)
    parser.add_argument("--beta_schedule", default="sigmoid", type=str,
                        help="linear | cosine | sigmoid | sigmoid1 | sigmoid2 | sigmoid3")
    parser.add_argument("--sample_time_range", default="None", type=str)
    parser.add_argument("--diffusion_objective", default="pred_v", type=str)
    parser.add_argument("--sampling_timesteps", default=None, type=int,
                        help="enable DDIM with this many steps (< diffusion_steps)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialise ResnetBlocks in the backward (larger crops/batches)")

    ## dataloader setting
    parser.add_argument("--data_root", default="./", type=str)
    add_path_flags(parser)
    parser.add_argument("--trainset", default="SonyTrainDataset", type=str)
    parser.add_argument("--testset", default="NoiseImageGenerationDataset", type=str)
    parser.add_argument("--save_test_root", default="generated", type=str)
    parser.add_argument("--crop_size", default=256, type=int)
    parser.add_argument("--batch_size", default=12, type=int)
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--multi_scale", action="store_true")
    parser.add_argument("--data_augmentation", action="store_true")
    parser.add_argument("--use_intensity_lw", action="store_true")

    ## optim setting
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--lr_D", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0, type=float)
    parser.add_argument("--start_iter", default=0, type=int,
                        help="epoch to resume from (reference quirk: "
                        "max_iter/start_iter count EPOCHS)")
    parser.add_argument("--max_iter", default=500, type=int)

    parser.add_argument("--loss_l1", action="store_true")
    parser.add_argument("--loss_mse", action="store_true")
    parser.add_argument("--loss_perceptual", action="store_true")
    parser.add_argument("--loss_adv", action="store_true")
    parser.add_argument("--gan_type", default="WGAN_GP", type=str)
    parser.add_argument("--lambda_l1", default=1, type=float)
    parser.add_argument("--lambda_mse", default=1, type=float)
    parser.add_argument("--lambda_perceptual", default=1, type=float)
    parser.add_argument("--lambda_adv", default=5e-3, type=float)

    parser.add_argument("--resume", default="", type=str,
                        help="a .pth/.pt or JAX .npz snapshot, or 'auto'")
    parser.add_argument("--resume_optim", default="", type=str)
    parser.add_argument("--resume_scheduler", default="", type=str,
                        help="accepted for reference-CLI compatibility; the LR "
                             "schedule is closed-form per epoch, so there is "
                             "no scheduler state to restore")

    ## log setting
    parser.add_argument("--log_freq", default=10, type=int)
    parser.add_argument("--vis_freq", default=100, type=int)
    parser.add_argument("--save_epoch_freq", default=30, type=int)
    parser.add_argument("--test_freq", default=100, type=int)
    parser.add_argument("--save_folder", default="./logs/noise_synthesis_newstart/weights",
                        type=str)
    parser.add_argument("--vis_step_freq", default=100, type=int)
    parser.add_argument("--use_tb_logger", action="store_true")
    parser.add_argument("--save_test_results", action="store_true")
    return parser


def main(argv=None):
    """Train; returns the trainer's summary of the run."""
    args = build_parser().parse_args(argv)
    set_random_seed(args.random_seed)
    init_distributed(args)
    try:
        setup_run_dirs(args)

        from ..train.trainer_diffusion import Trainer

        return Trainer(args).train()
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
