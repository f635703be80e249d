"""Launcher: ``python -m flexflow_tpu_torch user_script.py [flags]`` — the
analog of the reference's ``flexflow_python`` driver
(python/flexflow/driver.py, python/flexflow_python.py), which boots the
runtime and then runs the user script as the top-level task; a copy of
``flexflow_tpu/__main__.py``. Here there is no runtime to boot; the
launcher just makes the reference-style invocation work unchanged: the
script sees the remaining argv (picked up by ``FFConfig()``) and its own
directory on sys.path. It boots nothing, so the device rule stays with
``FFModel``: without a GPU the script's model raises unless the script
passes ``device="cpu"``.
"""
import os
import runpy
import sys


def main() -> None:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m flexflow_tpu_torch <script.py> [flags]\n"
              "Flags after the script are visible to FFConfig "
              "(-b, -e, --budget, --only-data-parallel, --compute-dtype, "
              "...).")
        return
    script = argv[0]
    if not os.path.exists(script):
        raise SystemExit(
            f"flexflow_tpu_torch launcher: no such script: {script}")
    sys.argv = argv  # script name + its flags, reference-style
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
