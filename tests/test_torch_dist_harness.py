"""The spawned-rank harness of the port's mesh tests
(``tests/torch_dist_pairs.py``): when a rank outlives the join's
deadline, ``finish`` kills it and raises naming the rank, the case it was
in and its threads' stacks (dumped through ``faulthandler`` on SIGUSR1),
so a rank that hangs under load is told apart from one that failed."""
import os
import time

import numpy as np
import pytest

import torch_dist_pairs as tp


def test_finish_names_a_hung_rank_its_case_and_its_stack(tmp_path):
    root = str(tmp_path)
    np.savez(os.path.join(root, "h_in.npz"), x=np.zeros(1))
    procs = tp.start(1, root, [("h", "hang", dict(seconds=600))])
    doing = os.path.join(root, "doing_r0.txt")
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        if os.path.exists(doing) and "case" in open(doing).read():
            break
        time.sleep(0.2)
    with pytest.raises(RuntimeError) as e:
        tp.finish(procs, root, timeout=1)
    msg = str(e.value)
    assert "rank 0: still running after 1 s, in case 'h' (hang)" in msg
    assert "_case_hang" in msg  # the rank's stack, from faulthandler
    assert not procs[0].is_alive()
