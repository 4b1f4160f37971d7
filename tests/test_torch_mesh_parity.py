"""A rank's program on a mesh held to the reference's, site by site.

Two child processes build the same sites on the same (2 data, 2 model)
mesh: the reference under ``jax.jit`` on four forced host devices, read by
``repro.hlo_analysis.analyze_hlo`` over the compiled per-device program,
and the port on a fake world of four ranks with DTensor inputs, read by
``repro_torch.hlo_analysis.analyze_hlo`` over its recorded rank graph.
Each reports the whole program's FLOPs (one device, no mesh) and one
rank's, so each site's share (whole / rank) compares across the two
packages, whose analyzers count some ops apart (the port's chunked WKV
scan keeps its final-state product, ~1% of ``time_mix``).

The sites: RecurrentGemma's gates (``rglru._gates``) and whole RG-LRU
block, banded local attention, chunked (flash) attention, the fused QKV
projection, the attention sublayer's head merge and output projection,
the gated MLP (fused), RWKV-6's time mix and channel mix; each with heads
that ``model`` divides (4 heads, 2 KV heads; the MLP's hidden 64) and
with heads it does not (3, 1; hidden 48).  The batch is over ``data``; the
parameters are replicated, then placed by each package's own rules
(``runtime/sharding.py``), the same in both.  A rank's share must be
within 5% of the reference's, and no rank computes more than the whole.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 0.05

# the sites, shared by both children: (kind, heads, KV heads)
SITES = [("gates", 4, 0), ("gates", 3, 0),
         ("rglru_block", 4, 0), ("rglru_block", 3, 0),
         ("banded", 4, 2), ("banded", 3, 1),
         ("chunked", 4, 2), ("chunked", 3, 1),
         ("qkv", 4, 2), ("qkv", 3, 1),
         ("attn_out", 4, 2), ("attn_out", 3, 1),
         ("mlp", 4, 0), ("mlp", 3, 0),
         ("time_mix", 4, 0), ("time_mix", 3, 0),
         ("channel_mix", 4, 0), ("channel_mix", 3, 0)]

# Each child builds a site's arguments with ``args_of`` ([(shape, an
# activation's logical axes, or a parameter's path in the reference's
# tree)], cfg), its function with ``site_fn``, and reports ``flops`` ->
# [whole, a rank with the parameters replicated, a rank with them placed
# by the rules].
_COMMON = textwrap.dedent('''
    import json, sys, types
    B, S, HD, WIN, S_RWKV, HD_RWKV = 2, 8, 4, 4, 16, 8
    BSD, BSHD = ("batch", None, None), ("batch", None, None, None)
    RGLRU = ["w_branch", "w_in", "w_out", "w_conv", "b_conv", "w_a", "b_a",
             "w_x", "b_x", "lam"]


    def rwkv_shapes(d, nh, hd, dd_r, lora_r):
        return {"mu_base": (d,), "mu_rkvwg": (5, d), "dd_w1": (d, 5 * dd_r),
                "dd_w2": (5, dd_r, d), "wr": (d, d), "wk": (d, d),
                "wv": (d, d), "wg": (d, d), "wo": (d, d), "w0": (d,),
                "w_lora_a": (d, lora_r), "w_lora_b": (lora_r, d),
                "u": (nh, hd), "ln_x_scale": (d,), "ln_x_bias": (d,),
                "cm_mu_k": (d,), "cm_mu_r": (d,), "cm_wk": (d, 2 * d),
                "cm_wv": (2 * d, d), "cm_wr": (d, d)}


    def args_of(kind, nh, nkv, dd_r, lora_r):
        """(activation / parameter specs, cfg) of one site."""
        if kind in ("gates", "rglru_block"):
            d = nh * HD
            cfg = types.SimpleNamespace(n_heads=nh, d_rnn_resolved=d,
                                        conv1d_width=4)
            shapes = {"w_branch": (d, d), "w_in": (d, d), "w_out": (d, d),
                      "w_conv": (4, d), "b_conv": (d,), "w_a": (nh, HD, HD),
                      "b_a": (d,), "w_x": (nh, HD, HD), "b_x": (d,),
                      "lam": (d,)}
            names = (["w_a", "w_x", "b_a", "b_x"] if kind == "gates"
                     else RGLRU)
            return ([((B, S, d), BSD, None)]
                    + [(shapes[n], None, "rglru/" + n) for n in names]), cfg
        if kind in ("banded", "chunked"):
            return [((B, S, nh, HD), BSHD, None),
                    ((B, S, nkv, HD), BSHD, None),
                    ((B, S, nkv, HD), BSHD, None)], None
        if kind == "qkv":
            cfg = types.SimpleNamespace(
                n_heads=nh, n_kv_heads=nkv, head_dim=HD,
                resolved_head_dim=HD, qkv_bias=False, qk_norm=False,
                rope_theta=10000.0)
            return [((B, S, 32), BSD, None),
                    ((32, nh * HD), None, "blocks/attn/wq"),
                    ((32, nkv * HD), None, "blocks/attn/wk"),
                    ((32, nkv * HD), None, "blocks/attn/wv")], cfg
        if kind == "attn_out":
            cfg = types.SimpleNamespace(n_heads=nh, n_kv_heads=nkv)
            return [((B, S, nh, HD), BSHD, None),
                    ((nh * HD, 32), None, "blocks/attn/wo")], cfg
        if kind == "mlp":                  # hidden 16 * nh
            return [((B, S, 16), BSD, None),
                    ((16, 16 * nh), None, "blocks/mlp/w_gate"),
                    ((16, 16 * nh), None, "blocks/mlp/w_up"),
                    ((16 * nh, 16), None, "blocks/mlp/w_down")], None
        d = nh * HD_RWKV
        cfg = types.SimpleNamespace(d_model=d, rwkv_head_dim=HD_RWKV,
                                    d_ff=2 * d)
        shapes = rwkv_shapes(d, nh, HD_RWKV, dd_r, lora_r)
        names = [n for n in shapes if n.startswith("cm_") ==
                 (kind == "channel_mix")]
        return ([((B, S_RWKV, d), BSD, None)]
                + [(shapes[n], None, "blocks/tm_cm/" + n) for n in names]), cfg
''')

_JAX = _COMMON + textwrap.dedent('''
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding

    from repro.hlo_analysis import analyze_hlo
    from repro.models import OFFLOAD_PLAN
    from repro.models import attention as A
    from repro.models import layers as L
    from repro.models import rglru as R
    from repro.models import rwkv as W
    from repro.runtime import sharding as shd
    from repro.runtime.pspec import axis_rules, constrain

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    rules = shd.make_rules(mesh)
    plan = OFFLOAD_PLAN.replace(compute_dtype="float32")
    pos = jnp.arange(S, dtype=jnp.int32)


    def site_fn(kind, names_cfg):
        names, cfg = names_cfg
        if kind == "gates":
            return lambda x, *ps: R._gates(x, dict(zip(names, ps)), cfg)
        if kind == "rglru_block":
            return lambda x, *ps: R.rglru_block(
                x, dict(zip(names, ps)), cfg, plan)[0]
        if kind == "banded":
            return lambda q, k, v: A.attend_local_banded(
                q, k, v, pos, pos, WIN, plan)
        if kind == "chunked":
            return lambda q, k, v: A.attend_chunked(
                q, k, v, pos, pos, True, 0, plan.replace(attn_kv_chunk=4))
        if kind == "qkv":
            return lambda x, q, k, v: A.project_qkv(
                x, {"wq": q, "wk": k, "wv": v}, cfg, plan,
                jnp.arange(S, dtype=jnp.int32))
        if kind == "mlp":
            return lambda x, g, u, dn: L.mlp(
                x, {"w_gate": g, "w_up": u, "w_down": dn}, "silu", plan)
        if kind == "attn_out":       # transformer._attn_sublayer_full
            return lambda o, wo: constrain(
                o.reshape(o.shape[0], o.shape[1], -1) @ wo,
                "batch", "seq", None)
        mix = W.time_mix if kind == "time_mix" else W.channel_mix
        return lambda x, *ps: mix(x, dict(zip(names, ps)), cfg, plan,
                                  None)[0]


    def flops(fn, args, cfg):
        def structs(specs):
            return [jax.ShapeDtypeStruct(s, jnp.float32, sharding=sp)
                    for (s, _, _), sp in zip(args, specs)]

        whole = jax.jit(fn).lower(*structs([None] * len(args)))
        out = [analyze_hlo(whole.compile().as_text(), 1).flops]
        for placed in (False, True):
            specs = []
            for s, ax, path in args:
                if path is not None:
                    ax = (shd._axes_for_param(path, len(s), cfg, mesh)
                          if placed else (None,) * len(s))
                specs.append(NamedSharding(mesh, rules.pspec(s, ax)))
            with axis_rules(rules):
                low = jax.jit(fn, in_shardings=tuple(specs)).lower(
                    *structs(specs))
            out.append(analyze_hlo(low.compile().as_text(), 4).flops)
        return out


    out = {}
    for kind, nh, nkv in json.loads(sys.argv[1]):
        args, cfg = args_of(kind, nh, nkv, W._DD_R, W._LORA_R)
        names = [a[2].split("/")[-1] for a in args if a[2]]
        out[f"{kind}_{nh}_{nkv}"] = flops(site_fn(kind, (names, cfg)),
                                          args, cfg)
    print("RESULT " + json.dumps(out))
''')

_TORCH = _COMMON + textwrap.dedent('''
    import math

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import hlo_analysis as ha
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.models import OFFLOAD_PLAN
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    from repro_torch.models import rwkv as W
    from repro_torch.models.transformer import _attn_out
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.pspec import axis_rules

    init_fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = shd.make_rules(mesh)
    plan = OFFLOAD_PLAN.replace(compute_dtype="float32")
    pos = torch.arange(S, dtype=torch.int32, device="meta")


    def site_fn(kind, names_cfg):
        names, cfg = names_cfg
        if kind == "gates":
            return lambda x, *ps: R._gates(x, dict(zip(names, ps)), cfg)
        if kind == "rglru_block":
            rec = R.LinearRecurrence()
            return lambda x, *ps: R.rglru_block(
                x, dict(zip(names, ps)), cfg, plan, rec)[0]
        if kind == "banded":
            return lambda q, k, v: A.attend_local_banded(
                q, k, v, pos, pos, WIN, plan)
        if kind == "chunked":
            return lambda q, k, v: A.attend_chunked(
                q, k, v, pos, pos, True, 0, plan.replace(attn_kv_chunk=4))
        if kind == "qkv":
            return lambda x, q, k, v: A.project_qkv(
                x, types.SimpleNamespace(wq=q, wk=k, wv=v), cfg, plan,
                torch.arange(S, device="meta"))
        if kind == "mlp":
            return lambda x, g, u, dn: L.mlp(
                x, {"w_gate": g, "w_up": u, "w_down": dn}, "silu", plan)
        if kind == "attn_out":
            return _attn_out
        if kind == "time_mix":
            rec = W.WKVRecurrence()
            return lambda x, *ps: W.time_mix(x, dict(zip(names, ps)), cfg,
                                             plan, None, rec)[0]
        return lambda x, *ps: W.channel_mix(x, dict(zip(names, ps)), cfg,
                                            plan, None)[0]


    def placed(shape, axes):
        """A meta DTensor of ``shape`` placed by the rules on ``axes``."""
        pl = rules.placements(shape, axes)
        local = list(shape)
        for p, n in zip(pl, mesh.shape):
            if isinstance(p, Shard):
                local[p.dim] //= n
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  pl, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


    def flops(fn, args, cfg):
        out = [ha.analyze_hlo(ha.lower(fn, *[
            torch.empty(s, device="meta") for s, _, _ in args]).gm, 1).flops]

        def under_rules(*a):
            with axis_rules(rules), implicit_replication():
                return fn(*a)

        for on_rules in (False, True):
            ins = [placed(s, (shd._ref_axes(path, len(s), cfg, mesh)
                              if on_rules else (None,) * len(s))
                          if path is not None else ax)
                   for s, ax, path in args]
            out.append(ha.analyze_hlo(ha.lower(under_rules, *ins).gm,
                                      4).flops)
        return out


    out = {}
    for kind, nh, nkv in json.loads(sys.argv[1]):
        args, cfg = args_of(kind, nh, nkv, W._DD_R, W._LORA_R)
        names = [a[2].split("/")[-1] for a in args if a[2]]
        out[f"{kind}_{nh}_{nkv}"] = flops(site_fn(kind, (names, cfg)),
                                          args, cfg)
    print("RESULT " + json.dumps(out))
''')


def _start(script: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(SITES)],
        env=dict(os.environ, PYTHONPATH="src", **env), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    line = next((ln for ln in out.splitlines() if ln.startswith("RESULT ")),
                None)
    assert line is not None, (out[-2000:], err[-3000:])
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def counts():
    """{site: [whole, rank replicated, rank on the rules]} of each
    package, the two children run side by side."""
    ref = _start(_JAX, {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                        "--xla_force_host_platform_device_count=4"})
    port = _start(_TORCH, {})
    return _result(ref), _result(port)


@pytest.mark.parametrize("placement", ["replicated", "rules"])
@pytest.mark.parametrize("kind,nh,nkv", SITES)
def test_rank_share_matches_the_reference(counts, kind, nh, nkv, placement):
    ref, port = counts
    key = f"{kind}_{nh}_{nkv}"
    col = 1 if placement == "replicated" else 2
    ref_share = ref[key][0] / ref[key][col]
    port_share = port[key][0] / port[key][col]
    assert port[key][col] <= port[key][0], (key, port[key])
    assert port_share == pytest.approx(ref_share, rel=TOL), (
        key, placement, ref[key], port[key])
