"""Path flags of the reference CLIs and their `DataPaths`.

Port of noisediff_tpu/config.py (path half): the reference's hard-coded
cluster paths are the --sid_folder / --pretrained_dir / ... flags.
"""
from __future__ import annotations

from argparse import Namespace

from .data.datasets import DataPaths


def paths_from_args(args: Namespace) -> DataPaths:
    def g(name, default):
        return getattr(args, name, None) or default

    return DataPaths(
        data_folder=g("sid_folder", "./SID"),
        train_list=getattr(args, "train_list", "") or "",
        test_list=getattr(args, "test_list", "") or "",
        val_list=getattr(args, "val_list", "") or "",
        synthetic_folder=g("synthetic_folder", "./NoiseDiff_GeneratedNoiseData"),
        resources_path=g("resources_path", "./resources"),
        pretrained_dir=g("pretrained_dir", "./pretrained_ckpts"),
        eld_folder=g("eld_folder", "./ELD/testset"),
        eld_val_list=g("eld_val_list", ""),
        eld_test_list=g("eld_test_list", ""),
        cache_dir=getattr(args, "cache_dir", None),
    )


def add_path_flags(parser) -> None:
    parser.add_argument("--sid_folder", default="./SID", type=str,
                        help="SID dataset root (contains Sony/ and the list files)")
    parser.add_argument("--train_list", default="", type=str)
    parser.add_argument("--test_list", default="", type=str)
    parser.add_argument("--val_list", default="", type=str)
    parser.add_argument("--synthetic_folder", default="./NoiseDiff_GeneratedNoiseData", type=str)
    parser.add_argument("--resources_path", default="./resources", type=str,
                        help="PMN darkshading resources")
    parser.add_argument("--pretrained_dir", default="./pretrained_ckpts", type=str)
    parser.add_argument("--eld_folder", default="./ELD/testset", type=str)
    parser.add_argument("--eld_val_list", default="", type=str)
    parser.add_argument("--eld_test_list", default="", type=str)
    parser.add_argument("--cache_dir", default=None, type=str,
                        help="packed-frame cache directory")
