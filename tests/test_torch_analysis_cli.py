"""``python -m flexflow_tpu_torch.analysis`` against the JAX package's
ShardLint command line (flexflow_tpu/analysis/__main__.py): for each demo
model, built-in strategy and injection, the same exit code and the same
rule ids on the same nodes; the same placements with ``--placements``;
the serving check's rules with ``--serving``; and the usage errors."""
import json
import subprocess
import sys

import pytest

from flexflow_tpu.analysis.__main__ import main as jax_cli
from flexflow_tpu_torch.analysis.__main__ import main as port_cli

STRATEGIES = ("dp", "tp", "hybrid", "pipeline", "remat")


def _run(cli, argv, capsys):
    """``cli(argv)``'s exit code and output, each package numbering its
    graph's nodes from 1 (the injected node's name embeds its guid)."""
    import itertools

    import flexflow_tpu.parallel.pcg as jax_pcg
    import flexflow_tpu_torch.parallel.pcg as port_pcg

    jax_pcg._node_guid = itertools.count(1)
    port_pcg._node_guid = itertools.count(1)
    rc = cli(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("inject", ["none", "drop", "duplicate"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", ["mlp", "attention"])
def test_same_exit_code_and_rules(model, strategy, inject, capsys):
    argv = ["--model", model, "--strategy", strategy, "--inject", inject,
            "--json"]
    jrc, jout, jerr = _run(jax_cli, argv, capsys)
    trc, tout, terr = _run(port_cli, argv, capsys)
    assert trc == jrc
    if jrc == 2:  # no reduction site to break: a usage error in both
        assert "cannot --inject" in terr and "cannot --inject" in jerr
        return
    # the strategy, the rules checked and fired, the counts
    assert json.loads(tout) == json.loads(jout)
    text = _run(port_cli, argv[:-1], capsys)[1].splitlines()
    assert text[1:] == _run(jax_cli, argv[:-1], capsys)[1].splitlines()[1:]


@pytest.mark.parametrize("flag", ["--placements", "--serving"])
def test_placements_and_serving_match(flag, capsys):
    argv = ["--model", "attention", "--strategy", "hybrid", flag]
    jrc, jout, _ = _run(jax_cli, argv, capsys)
    trc, tout, _ = _run(port_cli, argv, capsys)
    assert trc == jrc
    assert tout.splitlines()[1:] == jout.splitlines()[1:]


def test_usage_errors_exit_2(capsys):
    for argv in (["--model", "cnn"], ["--strategy", "zigzag"],
                 ["--strategy", "/nonexistent/plan.json"]):
        with pytest.raises(SystemExit) as e:
            port_cli(argv)
        assert e.value.code == 2
    capsys.readouterr()


def test_module_entry_point_runs_without_jax(tmp_path):
    """``python -m flexflow_tpu_torch.analysis`` in a fresh interpreter:
    the injected duplicate fails with FF001, and neither jax nor
    flexflow_tpu is loaded."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import runpy, sys\n"
            "sys.argv = ['x', '--model', 'mlp', '--strategy', 'hybrid', "
            "'--inject', 'duplicate']\n"
            "try:\n"
            "    runpy.run_module('flexflow_tpu_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('rc', e.code)\n"
            "print('leaked', sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('flexflow_tpu.') or m == 'flexflow_tpu'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert "FF001" in res.stdout and "rc 1" in res.stdout, res.stderr
    assert "leaked []" in res.stdout
