"""chip_smoke's harness on the CPU: its exit path (become_subreaper and
stop_children leave no process of the run behind, the resource tracker of a
spawned DataLoader and the ranks' forkserver included), and its section
timer (every phase of main is timed, and none of the phases main called
before the timer was added went missing)."""
import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "chip_smoke.py")

# the phases main called when it was first timed: none may be dropped
PHASES = {
    "phase_kernels", "phase_model", "phase_profile", "phase_int8_kernels", "phase_main",
    "phase_ddim", "phase_int8_generation", "phase_denoise", "phase_dist_cli",
    "phase_dist_gen", "phase_denoise_profile", "phase_evaluate", "phase_int8_evaluate",
    "phase_kld", "phase_fullframe", "phase_fullframe_sharded", "phase_denoise_check",
    "phase_train_check", "phase_train", "phase_train_wgrad", "phase_fp32_train",
    "phase_profile_cli", "phase_train_profile", "phase_dist_step", "phase_remat",
    "phase_train_sharded", "phase_gate", "phase_sweep", "phase_attention", "phase_dim96",
    "phase_posemb",
}
# calls of main that are not phase_* functions but take time of their own
TIMED_CALLS = {"run_generation", "check_poisson_on_card", "gen_setup", "reference_steps",
               "build_all"}

EXIT_SCRIPT = textwrap.dedent("""
    import json
    import os
    import subprocess
    import sys

    sys.path.insert(0, {root!r})
    import chip_smoke


    def state(pid):  # (state, parent) of pid from /proc, None once it is gone
        try:
            with open(f"/proc/{{pid}}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (FileNotFoundError, ProcessLookupError):
            return None
        return fields[0], int(fields[1])


    if __name__ == "__main__":
        chip_smoke.become_subreaper()
        # an orphan: sh exits at once, its background sleep is left to us
        sh = subprocess.Popen(["sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"],
                              stdout=subprocess.PIPE, text=True)
        orphan = int(sh.stdout.readline())
        sh.wait()
        from multiprocessing import forkserver, resource_tracker

        import torch

        loader = torch.utils.data.DataLoader(list(range(4)), batch_size=2, num_workers=1,
                                             multiprocessing_context="spawn")
        assert [b.tolist() for b in loader] == [[0, 1], [2, 3]]
        tracker = resource_tracker._resource_tracker._pid
        assert tracker is not None, "the spawned DataLoader started no resource tracker"
        chip_smoke.rank_context()  # the spawned ranks' server
        server = forkserver._forkserver._forkserver_pid
        stopped = chip_smoke.stop_children()
        print(json.dumps({{"me": os.getpid(), "orphan": orphan, "tracker": tracker,
                          "server": server, "stopped": stopped,
                          "states": {{"orphan": state(orphan), "tracker": state(tracker),
                                     "server": state(server)}}}}))
""")


def _state(pid: int):
    """(state, parent) of pid from /proc, None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (FileNotFoundError, ProcessLookupError):
        return None
    return fields[0], int(fields[1])


def _lingers(state, parent: int) -> bool:
    """Whether a process in `state` still runs, or is a zombie still
    parented to `parent`."""
    return state is not None and (state[0] != "Z" or state[1] == parent)


def test_stop_children_leaves_no_process(tmp_path):
    """A script that is its descendants' subreaper, leaves an orphaned
    grandchild, runs a spawned DataLoader to its end and starts the ranks'
    forkserver, then calls stop_children: it exits 0, names the resource
    tracker on stderr, and neither the orphan, the tracker nor the server
    is left, when stop_children returns or after the script has ended."""
    if not os.path.isdir("/proc"):
        pytest.skip("no /proc: the exit path reads the process table there")
    script = tmp_path / "exit_path.py"
    script.write_text(EXIT_SCRIPT.format(root=ROOT))
    proc = subprocess.Popen([sys.executable, str(script)], cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert "resource tracker" in err, err[-4000:]
    got = json.loads(out.splitlines()[-1])
    assert got["me"] == proc.pid
    for what in ("orphan", "tracker", "server"):
        state = got["states"][what]
        assert not _lingers(state and tuple(state), proc.pid), \
            f"the {what} {got[what]} was left running when stop_children returned: {state}"
        assert not _lingers(_state(got[what]), proc.pid), \
            f"the {what} {got[what]} outlived the script"
    assert f"process {got['orphan']}" in err, err[-4000:]
    assert f"resource tracker {got['tracker']}" in err, err[-4000:]


def _main_tree():
    tree = ast.parse(open(SOURCE).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    parents = {}
    for node in ast.walk(main):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return main, parents


def _called(call: ast.Call):
    f = call.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None


def _in_timed(node, parents) -> bool:
    while node in parents:
        node = parents[node]
        if isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call) and _called(i.context_expr) == "timed"
                for i in node.items):
            return True
    return False


def test_every_phase_of_main_is_timed():
    """Every call in chip_smoke.main to a phase, to run_generation,
    check_poisson_on_card, gen_setup, reference_steps and _build.build_all
    sits inside a `with timed(...)` block, main calls exactly the phases it
    called when the timer was added, and the phase_seconds line's total_s is
    not overwritten before it is printed."""
    main, parents = _main_tree()
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)]
    watched = [c for c in calls
               if (_called(c) or "").startswith("phase_") or _called(c) in TIMED_CALLS]
    untimed = sorted({_called(c) for c in watched if not _in_timed(c, parents)})
    assert not untimed, f"called outside a timed block: {untimed}"
    assert {_called(c) for c in watched} >= TIMED_CALLS
    assert {_called(c) for c in calls if (_called(c) or "").startswith("phase_")} == PHASES
    # the phase_seconds line's total_s is a name main assigns once, the run's seconds
    total = [d.values[d.keys.index(k)] for d in ast.walk(main) if isinstance(d, ast.Dict)
             for k in d.keys if isinstance(k, ast.Constant) and k.value == "total_s"]
    assert len(total) == 1 and isinstance(total[0], ast.Name)
    assigned = [t for n in ast.walk(main) if isinstance(n, ast.Assign) for t in n.targets
                if isinstance(t, ast.Name) and t.id == total[0].id]
    assert len(assigned) == 1, f"{total[0].id} is assigned {len(assigned)} times in main"


@pytest.mark.parametrize("fails", [False, True])
def test_timed_records_and_logs(fails, capsys, monkeypatch):
    """timed adds the block's seconds to PHASE_SECONDS and logs them, and on
    an exception logs them all the same and lets the exception through."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PHASE_SECONDS", {"x": 1.0})
    if fails:
        with pytest.raises(ValueError, match="boom"):
            with chip_smoke.timed("x"):
                raise ValueError("boom")
    else:
        with chip_smoke.timed("x"):
            pass
    with chip_smoke.timed("y"):
        pass
    assert set(chip_smoke.PHASE_SECONDS) == {"x", "y"}
    assert 1.0 <= chip_smoke.PHASE_SECONDS["x"] < 2.0  # a name met twice adds up
    assert 0.0 <= chip_smoke.PHASE_SECONDS["y"] < 1.0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["x", "phase"], ["y", "phase"]]
    assert all(ln.startswith("  ") and ln.endswith(" s") for ln in lines)
