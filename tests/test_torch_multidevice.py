"""The port's sharded paths on 8 CPU ranks (``gloo``, one child process
that spawns them), held against single-device results.

The reference's own 8-device tests (``tests/test_multidevice.py``) fail
under jax 0.9, so the oracle is the reference's *single-device* loss on
the same parameters (its ``REFERENCE_PLAN`` in f32), computed here and
handed to the ranks with the parameters (through ``model_from_jax``):

* on a (2 data, 4 model) mesh, the reference's mini MoE under the
  ``OFFLOAD_PLAN`` (chunked attention in ``local_map``, ``scatter_ep``,
  which takes the expert-parallel body) and its 4-head RWKV-6 (the chunked
  WKV in ``local_map``): the sharded loss within the reference's 5e-3 of
  the reference's and within 1e-5 of the port's unsharded loss;
* a (pod 2, data 2) ``make_compressed_dp_step``: without compression one
  step matches the unsharded step within 1e-6; with it, the update
  differs from the exact one by at most half the int8 quantisation step
  (an AdamW whose first update is the gradient, so that the parameters
  show the reduced gradient);
* ``reshard``: a checkpoint saved on (2, 4) restores on (4, 2) and (1, 8)
  bit for bit in full tensors."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro.models import REFERENCE_PLAN, build_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REF = 5e-3          # the reference's own multi-device tolerance
TOL_PORT = 1e-5

MINI_MOE = dict(arch_id="mini_moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96, vocab=256,
                mlp_act="silu", tie_embeddings=False)
MINI_MOE_EXPERTS = dict(n_experts=8, top_k=2, d_ff_expert=96,
                        capacity_factor=8.0)          # no drops

_RANKS = textwrap.dedent('''
    import dataclasses, json, os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def tree(flat):
        out = {}
        for key, v in flat.items():
            node, parts = out, key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out

    def work(rank, world, store_path, data_path, out_path):
        torch.set_num_threads(1)          # eight ranks share the host's cores
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs.base import ArchConfig, MoEConfig, get_config
        from repro_torch.models import OFFLOAD_PLAN, build_model
        from repro_torch.models import attention as A
        from repro_torch.models import moe as M
        from repro_torch.models.convert import model_from_jax
        from repro_torch.optim import OptimizerConfig
        from repro_torch.runtime import pspec
        from repro_torch.runtime import sharding as shd
        from repro_torch.runtime.fault_tolerance import reshard
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.runtime.train import (
            init_train_state, jit_train_step, make_compressed_dp_step,
            make_train_step, state_shardings)

        t0 = time.time()
        spec = json.load(open(os.path.join(data_path, "spec.json")))
        out = {}
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        rules = shd.make_rules(mesh)
        bodies = []
        local_map = pspec.local_map

        def counting(fn, *a, **k):
            bodies.append(fn.__qualname__.split(".")[0])
            return local_map(fn, *a, **k)

        pspec.local_map = counting
        A.local_map = counting
        ep = []
        ep_orig = M.moe_scatter_ep_sharded

        def ep_count(*a, **k):
            r = ep_orig(*a, **k)
            ep.append(r is not None)
            return r

        M.moe_scatter_ep_sharded = ep_count
        plan = OFFLOAD_PLAN.replace(attn_kv_chunk=16, wkv_chunk=16,
                                    loss_vocab_chunk=64,
                                    compute_dtype="float32")
        cases = {"moe": (ArchConfig(**spec["moe_cfg"], moe=MoEConfig(
                     **spec["moe_experts"])), plan),
                 "rwkv": (dataclasses.replace(
                     get_config("rwkv6_3b").reduced(), d_model=64,
                     rwkv_head_dim=16), plan.replace(wkv_chunk=8))}
        for name, (cfg, p) in cases.items():
            flat = dict(np.load(os.path.join(data_path, name + "_params.npz")))
            batch = {k: torch.from_numpy(v) for k, v in np.load(
                os.path.join(data_path, name + "_batch.npz")).items()}
            params = model_from_jax(tree(flat), cfg, device="cpu")
            model = build_model(cfg)
            with torch.no_grad():
                plain = float(model.loss(params, batch, p)[0])
            shd.distribute(params, rules,
                           shd.param_logical_axes(params, cfg, mesh))
            b = shd.distribute(batch, rules, shd.batch_logical_axes(batch))
            bodies.clear(); ep.clear()
            with torch.no_grad(), pspec.axis_rules(rules), \\
                    implicit_replication():
                loss = model.loss(params, b, p)[0].full_tensor()
            out[name] = {"plain": plain, "sharded": float(loss),
                         "bodies": sorted(set(bodies)), "ep": ep[:]}
        pspec.local_map = A.local_map = local_map
        out["t_losses"] = time.time() - t0

        # -- compressed DP on (pod 2, data 2), two replicas of it ----------
        cfg = get_config("qwen3_0_6b").reduced()
        model = build_model(cfg)
        batch = model.demo_batch(torch.Generator().manual_seed(1), 8, 16,
                                 device="cpu")
        dp_mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=(
            "replica", "pod", "data"))["pod", "data"]
        # an AdamW whose first step is g * lr / (|g| + eps): at lr = eps
        # the update is the gradient to first order, so the parameters
        # move by what the reduced gradient moves (a sign-like default
        # AdamW step would amplify rounding noise in tiny gradients)
        eps = 1e3
        lin = OptimizerConfig(eps=eps, weight_decay=0.0, clip_norm=1e9)
        one = lambda step: eps

        def fresh(comp=False):
            return init_train_state(model, torch.Generator().manual_seed(0),
                                    with_compression=comp, device="cpu")

        ex = make_train_step(model, plan, lin, one)(fresh(), batch)[0]
        dp = make_compressed_dp_step(model, plan, lin, one, dp_mesh,
                                     compress=False)(fresh(True), batch)[0]
        out["dp_exact_diff"] = max(
            float((a - b).abs().max()) for a, b in zip(
                ex.params.parameters(), dp.params.parameters()))
        cp = make_compressed_dp_step(model, plan, lin, one, dp_mesh,
                                     compress=True)(fresh(True), batch)[0]
        out["t_dp"] = time.time() - t0
        # the int8 step of each tensor: the largest pod gradient's / 127
        halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()}
                  for i in range(2)]
        pod_grads = []
        for h in halves:
            ps = init_train_state(model, torch.Generator().manual_seed(0),
                                  device="cpu").params
            named = dict(ps.named_parameters())
            loss = model.loss(ps, h, plan)[0]
            pod_grads.append(dict(zip(named, torch.autograd.grad(
                loss, list(named.values())))))
        ratio, moved = 0.0, 0.0
        for (k, a), b in zip(ex.params.named_parameters(),
                             cp.params.parameters()):
            step = max(float(g[k].abs().max()) for g in pod_grads) / 127
            d = float((a - b).abs().max())
            moved = max(moved, d)
            # half an int8 step, plus the f32 rounding of the parameter
            bound = 0.5 * step + 4 * 2.0 ** -23 * float(a.abs().max())
            ratio = max(ratio, d / bound)
        out["compressed_ratio"] = ratio
        out["compressed_moved"] = moved

        # -- reshard: saved on (2, 4), restored on (4, 2) and (1, 8) -------
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 device="cpu")
        step = jit_train_step(model, plan, OptimizerConfig(),
                              lambda s: 1e-3, rules,
                              state_shardings(state, rules, cfg))
        state, _ = step(state, batch)
        out["t_step"] = time.time() - t0
        ckpt_dir = os.path.join(data_path, "ckpt")
        ckpt = CheckpointManager(ckpt_dir, async_save=False)
        ckpt.save(1, state, blocking=True)
        dist.barrier()
        want = {"params/" + n: p.full_tensor() for n, p in
                state.params.named_parameters()}
        want.update({f"opt/mu/{n}": v.full_tensor()
                     for n, v in state.opt.mu.items()})
        equal = {}
        for shape in ((4, 2), (1, 8)):
            m2 = init_device_mesh("cpu", shape,
                                  mesh_dim_names=("data", "model"))
            r2 = shd.make_rules(m2)
            tmpl = init_train_state(model, torch.Generator().manual_seed(5),
                                    device="cpu")
            _, got = reshard(ckpt, tmpl, state_shardings(tmpl, r2, cfg))
            leaves = {"params/" + n: p for n, p in
                      got.params.named_parameters()}
            leaves.update({f"opt/mu/{n}": v for n, v in got.opt.mu.items()})
            # every rank gathers every leaf (a collective), then compares
            full = {k: v.full_tensor() for k, v in leaves.items()}
            bad = sorted(k for k, v in leaves.items()
                         if tuple(v.device_mesh.shape) != shape
                         or not torch.equal(full[k], want[k]))
            equal["x".join(map(str, shape))] = bad or True
        out["reshard"] = equal
        out["t_all"] = time.time() - t0
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        data_path, out_path = sys.argv[1], sys.argv[2]
        store = os.path.join(data_path, "store")
        mp.spawn(work, args=(8, store, data_path, out_path), nprocs=8)
''')


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _reference(cfg, batch_size, data, name):
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    batch = model.demo_batch(jax.random.key(1), batch_size, 32)
    plan = REFERENCE_PLAN.replace(compute_dtype="float32")
    loss = float(jax.jit(lambda p, b: model.loss(p, b, plan)[0])(params,
                                                                   batch))
    np.savez(data / f"{name}_params.npz", **_flat(params))
    np.savez(data / f"{name}_batch.npz",
             **{k: np.asarray(v) for k, v in batch.items()})
    return loss


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = tmp_path_factory.mktemp("multidevice")
    ref = {"moe": _reference(ArchConfig(**MINI_MOE, moe=MoEConfig(
        **MINI_MOE_EXPERTS)), 8, data, "moe"),
        "rwkv": _reference(dataclasses.replace(
            ref_get_config("rwkv6_3b").reduced(), d_model=64,
            rwkv_head_dim=16), 4, data, "rwkv")}
    (data / "spec.json").write_text(json.dumps(
        {"moe_cfg": MINI_MOE, "moe_experts": MINI_MOE_EXPERTS}))
    script = data / "ranks.py"
    script.write_text(_RANKS)
    out = data / "out.json"
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, str(script), str(data), str(out)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.exists(), (res.stdout[-2000:], res.stderr[-4000:])
    return ref, json.loads(out.read_text())


def test_sharded_moe_loss_matches_single_device(ranks):
    ref, got = ranks
    moe = got["moe"]
    assert moe["ep"] and all(moe["ep"]), moe      # the expert-parallel body
    assert "moe_scatter_ep_sharded" in moe["bodies"]
    assert "attend_chunked" in moe["bodies"]     # flash in local_map
    assert abs(moe["sharded"] - ref["moe"]) < TOL_REF, (moe, ref)
    assert abs(moe["sharded"] - moe["plain"]) < TOL_PORT, moe


def test_sharded_rwkv_loss_matches_single_device(ranks):
    ref, got = ranks
    rwkv = got["rwkv"]
    assert "wkv_chunked" in rwkv["bodies"], rwkv
    assert abs(rwkv["sharded"] - ref["rwkv"]) < TOL_REF, (rwkv, ref)
    assert abs(rwkv["sharded"] - rwkv["plain"]) < TOL_PORT, rwkv


def test_compressed_dp_step(ranks):
    _, got = ranks
    assert got["dp_exact_diff"] <= 1e-6, got
    # compression moved the update, by no more than the int8 step does
    assert got["compressed_moved"] > 0.0
    assert got["compressed_ratio"] <= 1.0 + 1e-3, got


def test_reshard_restores_bit_equal_on_other_meshes(ranks):
    _, got = ranks
    assert got["reshard"] == {"4x2": True, "1x8": True}, got["reshard"]
