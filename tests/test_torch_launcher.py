"""``python -m flexflow_tpu_torch script.py [flags]``, in a fresh process.

The launcher (flexflow_tpu_torch/__main__.py, a copy of the JAX package's)
prints its usage with no arguments and on ``-h``, exits through
``SystemExit`` for a missing script, and runs a script as ``__main__``
with its flags in ``sys.argv`` (read by ``FFConfig()``) and its own
directory first on ``sys.path``. It loads no jax, and it boots nothing:
on a host without a GPU the script's ``FFModel(FFConfig())`` raises, and
runs once the script passes ``device="cpu"``.
"""
import json
import os
import subprocess
import sys
import textwrap

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(*args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "flexflow_tpu_torch",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def _script(tmp_path, body: str) -> str:
    d = tmp_path / "user"
    d.mkdir(exist_ok=True)
    (d / "helper_mod.py").write_text("VALUE = 7\n")
    path = d / "train.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_usage_on_no_arguments_and_on_help():
    for args in ((), ("-h",), ("--help",)):
        res = _launch(*args)
        assert res.returncode == 0, res.stderr
        assert res.stdout.startswith(
            "usage: python -m flexflow_tpu_torch <script.py> [flags]")


def test_missing_script_exits():
    res = _launch("no_such_script.py")
    assert res.returncode == 1
    assert "flexflow_tpu_torch launcher: no such script: no_such_script.py" \
        in res.stderr


def test_script_runs_as_main_with_its_flags(tmp_path):
    path = _script(tmp_path, """\
        import json, os, sys
        import helper_mod  # from the script's own directory
        from flexflow_tpu_torch import DataType, FFConfig

        c = FFConfig()
        print(json.dumps({
            "name": __name__, "argv": sys.argv,
            "path0": sys.path[0], "helper": helper_mod.VALUE,
            "batch_size": c.batch_size, "epochs": c.epochs,
            "bf16": c.compute_dtype == DataType.DT_BFLOAT16,
            "jax": sorted(m for m in sys.modules
                          if m == "jax" or m.startswith("jax.")
                          or m == "flexflow_tpu"
                          or m.startswith("flexflow_tpu.")),
        }))
    """)
    res = _launch(path, "-b", "16", "-e", "3", "--compute-dtype", "bf16",
                  cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["name"] == "__main__"
    assert got["argv"] == [path, "-b", "16", "-e", "3", "--compute-dtype",
                           "bf16"]
    assert got["path0"] == os.path.dirname(path) and got["helper"] == 7
    assert (got["batch_size"], got["epochs"], got["bf16"]) == (16, 3, True)
    assert got["jax"] == []


def test_device_rule_holds_in_the_launched_script(tmp_path):
    path = _script(tmp_path, """\
        import json, sys
        import numpy as np
        from flexflow_tpu_torch import FFConfig, FFModel, LossType

        try:
            FFModel(FFConfig())
            raised = None
        except RuntimeError as e:
            raised = str(e)
        c = FFConfig()
        ff = FFModel(c, device="cpu")
        x = ff.create_tensor((c.batch_size, 4))
        ff.softmax(ff.dense(x, 3))
        ff.compile(loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        rng = np.random.default_rng(0)
        perf = ff.fit(rng.standard_normal((16, 4)).astype(np.float32),
                      rng.integers(0, 3, (16, 1)).astype(np.int32))
        print(json.dumps({"raised": raised, "device": str(ff.device),
                          "trained": perf.train_all}))
    """)
    res = _launch(path, "-b", "8", "-e", "1")
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    if torch.cuda.is_available():
        assert got["raised"] is None
    else:
        assert "device='cpu'" in got["raised"]
    assert got["device"] == "cpu" and got["trained"] == 16
