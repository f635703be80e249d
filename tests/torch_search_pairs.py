"""Spawned gloo ranks for the port's searched compile
(tests/test_torch_search_gloo.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone
(``torch_dist_pairs`` builds the models and spawns the ranks). Cases:

* ``searched``: the tiny BERT compiled with no strategy at the world size,
  so every rank runs the Unity search (on the machine file of the case's
  config). Per rank: the agreed digest, the strategy's JSON, the rewritten
  graph's node names, each resharding node's name, target spec and planned
  layouts (as the op computes its output and after the plan) and the local
  shapes of its input and output in a forward, then one train step on the
  case's weights (loss, params after it);
* ``mismatch``: the same compile with rank 1's digest forced to differ;
  every rank must raise, naming rank 1 (the message is returned).
"""
import dataclasses
import itertools

import numpy as np

import torch_dist_pairs as tp


def _reshard_nodes(ff, x) -> dict:
    """Each resharding node with a ``target_pts``: its planned layouts and
    the local shapes of its input and output in a forward of ``x``."""
    import torch

    from flexflow_tpu_torch.ops.base import OpContext

    ex = ff.executor
    plans = ex._plan()
    (xs,) = ex.local_batch([x])
    with torch.no_grad():
        values = ex.forward_outputs(
            ff.params, ex._bind_inputs([torch.tensor(xs)]),
            OpContext(training=False, device=ex.device))
    out = []
    for node in ff.pcg.topo_order():
        if getattr(node.op, "target_pts", None) is None:
            continue
        g, i = node.inputs[0]
        pl = plans[node.guid]
        out.append("|".join([
            node.name, repr(node.op.target_pts.partition_spec()),
            repr(pl.natural[0]), repr(pl.outs[0]),
            repr(tuple(values[g][i].shape)),
            repr(tuple(values[node.guid][0].shape))]))
    return out


def jax_fields(machine) -> dict:
    """The fields of the port's ``GPUMachineModel`` that the JAX package's
    ``TPUMachineModel`` takes, after setting ``machine``'s fp32 matmul
    rate (the port's alone) to 0: the JAX rule, every matmul at
    ``peak_flops``, so that both packages price alike."""
    machine.matmul_flops_f32 = 0.0
    fields = dataclasses.asdict(machine)
    del fields["matmul_flops_f32"]
    return fields


def fresh_guids():
    """Number the next PCG nodes from 1, as the test process does for the
    JAX package's graph: the names the search's rewrites make embed node
    guids (``reduction_<guid>``)."""
    import flexflow_tpu_torch.parallel.pcg as pcg_module

    pcg_module._node_guid = itertools.count(1)


def _case_searched(ff_args, io):
    fresh_guids()
    ff = tp.build(**ff_args)
    pcg = ff.pcg
    res = {"digest": np.array(ff._search_digest),
           "strategy": np.array(ff.strategy.to_json(pcg)),
           "nodes": np.array([n.name for n in pcg.topo_order()]),
           "reshard": np.array(_reshard_nodes(ff, io["x"]))}
    ff.set_params_numpy(tp.unflat("w", io))
    loss, _grads, params = tp.one_step(ff, io["x"], io["y"])
    res["loss"] = np.float64(loss)
    res.update(tp.flat("p", params))
    return res


def _case_mismatch(ff_args, io):
    import torch.distributed as dist

    import flexflow_tpu_torch.model as fm

    fresh_guids()
    real = fm._search_digest
    if dist.get_rank() == 1:
        fm._search_digest = lambda pcg, s: "forced-" + real(pcg, s)
    try:
        tp.build(**ff_args)
    except RuntimeError as e:
        return {"error": np.array(str(e))}
    finally:
        fm._search_digest = real
    return {"error": np.array("")}


CASES = {"searched": _case_searched, "mismatch": _case_mismatch}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)
