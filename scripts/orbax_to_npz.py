"""Convert the JAX package's orbax snapshot directories into the flat `.npz`
that the PyTorch port reads.

A single-process JAX training run saves every `net`, `ema` and
`optimizer_G` snapshot as an orbax directory `{name}_{epoch}`
(noisediff_tpu/train/checkpoint.save_component); a multi-process run
writes a flat `{name}_{epoch}.npz` instead (`_save_npz`: one array per
leaf, named by its `jax.tree_util.keystr` path). The port reads only the
`.npz` (noisediff_tpu_torch/weights.load_state_dict_file, load_jax_opt_npz):
orbax stores are zstd-compressed, and the port imports neither orbax nor
a zstd decoder. This script runs where jax and orbax are installed,
restores each directory with the JAX package's `load_component` and writes
the `.npz` that `_save_npz` would have written, beside the directory.

    python scripts/orbax_to_npz.py <run>/snapshot          # every {name}_{epoch} in it
    python scripts/orbax_to_npz.py <run>/snapshot/net_10   # one component

An `optimizer_G` payload is restored against the optax state the JAX
trainers build (`train/state.make_optimizer`, with weight decay where the
saved chain holds its state, over the saved moments' own tree), so its key
paths are those of the live state (`.inner_state[0].mu[...]`), which the
port's `load_jax_opt_npz` reads; a parameter tree (`net`, `ema`, LSID's
`net`) is nested dicts whose paths need no target.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from noisediff_tpu.train import checkpoint  # noqa: E402
from noisediff_tpu.train.state import make_optimizer  # noqa: E402

# the files orbax's StandardCheckpointer writes into a component's directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA")


def is_component(path: str) -> bool:
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                       for m in _ORBAX_MARKERS)


def _optimizer_target(restored):
    """The live layout of an optax payload restored as plain containers
    (namedtuples come back as dicts, tuples as lists): {'opt_state', 'step'
    [, 'ema_step']} or a bare opt_state (the legacy layout). None for a
    parameter tree."""
    opt = restored.get("opt_state", restored)
    if not isinstance(opt, dict) or "inner_state" not in opt:
        return None
    inner = opt["inner_state"]
    adam = [i for i, s in enumerate(inner) if isinstance(s, dict) and "mu" in s]
    if len(adam) != 1 or adam[0] not in (0, 1):
        raise ValueError("not an optax state of train/state.make_optimizer: its chain holds "
                         f"{len(inner)} states")
    # make_optimizer's chain: [add_decayed_weights,] scale_by_adam, scale_by_learning_rate
    state = make_optimizer(weight_decay=1.0 if adam[0] == 1 else 0.0).init(inner[adam[0]]["mu"])
    return state if "opt_state" not in restored else {**restored, "opt_state": state}


def convert(path: str) -> str:
    """Restore the component at `path` and write `path`.npz; returns it."""
    path = os.path.abspath(path.rstrip(os.sep))
    tree = checkpoint.load_component(path)
    target = _optimizer_target(tree)
    if target is not None:
        tree = checkpoint.load_component(path, like=target)
    checkpoint._save_npz(path, checkpoint._to_numpy_tree(tree))
    return path + ".npz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="orbax component directories ({name}_{epoch}) or snapshot "
                         "directories holding them")
    args = ap.parse_args(argv)
    for path in args.paths:
        if is_component(path):
            todo = [path]
        else:
            todo = sorted(os.path.join(path, e) for e in os.listdir(path)
                          if is_component(os.path.join(path, e)))
            if not todo:
                raise SystemExit(f"{path}: no orbax snapshot directory here")
        for component in todo:
            print(f"{component} -> {convert(component)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
