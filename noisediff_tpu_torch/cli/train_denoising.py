"""Denoiser training CLI — trains LSID on the GPU.

Port of noisediff_tpu/cli/train_denoising.py: the same flags and defaults
(reference train_denoising.py:33-151), plus --device (default cuda; pass
--device cpu to run without a GPU). The canonical run (script.sh:24):

  python -m noisediff_tpu_torch.cli.train_denoising --use_tb_logger \
    --loss_l1 --save_epoch_freq 50 --crop_size 256 --sub_darkshading \
    --use_sna --name train_denoising_noisediffstar \
    --trainset SyntheticNoisDiffDenoisingDataset --batch_size 4 \
    --max_iter 500 --save_folder ./logs/denoising_newstart/weights

--synthetic_folder holds the generation CLI's output, one
ISO{iso}_Ratio{ratio} folder of 'clean+noisy+x_y.npy' patches per pair;
--sid_folder the SID tree whose Sony/long frames are the clean images;
--resources_path the PMN dark-shading resources. bf16 compute over fp32
parameters (--no_mixed_precision for fp32). Snapshots go to
<save_folder>/<name>/snapshot as {net,optimizer_G}_*.pth and net_final.pth.
--resume takes a .pth/.pt or a JAX .npz snapshot, or 'auto' (the newest
snapshot of this run); --resume_optim an optimizer_G .pth or a JAX .npz.
Flags the JAX trainer ignores (--loss_perceptual, --loss_adv, ...) are
accepted and ignored; `--launcher pytorch` under torchrun trains
data-parallel, one process per card (see cli/train_diffusion.py). --phase test
runs the network over --testset (one of the trainsets, in order, no
augmentation) under no_grad and returns the batches run: the JAX trainer's
vestigial test; the evaluation proper is the test_denoising CLI.
"""
from __future__ import annotations

import argparse

from ..config import add_path_flags
from ..parallel import mesh
from .common import add_device_flags, init_distributed, set_random_seed, setup_run_dirs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Denoising Training (PyTorch/CUDA)")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--name", default="train_denoising_1101_SID_raw", type=str)
    parser.add_argument("--phase", default="train", type=str)

    ## device setting
    add_device_flags(parser)

    ## network setting
    parser.add_argument("--net_name", default="LSID", type=str, help="LSID | ")
    parser.add_argument("--dim", default=48, type=int)
    parser.add_argument("--lsid_width", default=32, type=int,
                        help="LSID level-1 width (extension; 32 = reference)")
    parser.add_argument("--inp_dim", default=4, type=int)
    parser.add_argument("--cond_dim", default=4, type=int)

    ## dataloader setting
    parser.add_argument("--data_root", default="./", type=str)
    add_path_flags(parser)
    parser.add_argument("--trainset", default="SyntheticNoisDiffDenoisingDataset", type=str,
                        help="SyntheticNoisDiffDenoisingDataset | RealSonyDenoisingDataset"
                             " | PossionGaussianDenoisingDataset")
    parser.add_argument("--testset", default="TestSet", type=str)
    parser.add_argument("--save_test_root", default="generated", type=str)
    parser.add_argument("--crop_size", default=256, type=int)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--data_augmentation", action="store_true")
    parser.add_argument("--iso_value", default=250, type=float)
    parser.add_argument("--ratio_value", default=100, type=float)
    parser.add_argument("--train_iso", default=250, type=int)
    parser.add_argument("--train_ratio", default=100, type=int)
    parser.add_argument("--use_intensity_lw", action="store_true")
    parser.add_argument("--clean_folder", default="", type=str)
    parser.add_argument("--noisy_folder", default="", type=str)

    parser.add_argument("--sub_darkshading", action="store_true")
    parser.add_argument("--use_sna", action="store_true")

    ## optim setting
    parser.add_argument("--lr", default=2e-4, type=float)
    parser.add_argument("--lr_D", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0, type=float)
    parser.add_argument("--start_iter", default=0, type=int,
                        help="epoch to resume from (max_iter/start_iter count EPOCHS)")
    parser.add_argument("--max_iter", default=200, type=int)

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
    parser.add_argument("--save_folder", default="../logs/denoising/weights_0916", type=str)
    parser.add_argument("--vis_step_freq", default=100, type=int)
    parser.add_argument("--use_tb_logger", action="store_true")
    parser.add_argument("--save_test_results", action="store_true")
    return parser


def main(argv=None):
    """Train (--phase train) and return the trainer's summary of the run,
    or run the test loader's forward (any other phase) and return the
    batches run."""
    args = build_parser().parse_args(argv)
    set_random_seed(args.random_seed)
    init_distributed(args)
    try:
        setup_run_dirs(args)

        from ..train.trainer_denoising import Trainer

        trainer = Trainer(args)
        return trainer.train() if args.phase == "train" else trainer.test()
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
