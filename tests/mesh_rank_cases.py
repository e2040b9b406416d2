"""The port's checks on a world of four CPU ranks (gloo), shared by
``tests/test_torch_mesh_ranks.py``: one spawn runs every check on the
meshes (2, 2) and (1, 4) named ("data", "model") and hands rank 0's
results back as numpy arrays. This module imports no JAX, so the spawned
ranks start quickly; the tests compare the results with the unsharded runs
and with the JAX package in their own process.

Every check calls its collectives on every rank: a gather on one rank alone
would hang the others."""
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
MESHES = ((2, 2), (1, 4))
TRAIN_ARCHS = ("qwen3-0.6b", "mixtral-8x7b", "mamba2-2.7b",
               "recurrentgemma-9b", "whisper-small")
TRAIN_SHAPE = ("t", 32, 4, "train")           # seq 32, batch 4
# microbatches of global rows: on (2, 2) each microbatch of 2 rows takes
# one row from each data rank (MoE's aux loss is not linear in the rows)
MB_ARCHS, MB_MESH, MICROBATCHES = ("qwen3-0.6b", "mixtral-8x7b"), (2, 2), 2
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 4, 16, 3
MOE_EXPERTS = 3          # experts that divide neither "model" axis (the
#                          mixtral layout at full size: 8 over 16)
MOE_FACTORS = (8.0, 0.6)  # without and with dropped choices
MOE_X = (4, 16)          # batch, seq


def f32_params(cfg, seed=0):
    """The port's seeded initial parameters of ``cfg``, in f32."""
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    g = torch.Generator().manual_seed(seed)
    return pm.tree_map(lambda t: t.float(), api.init_params(cfg, g, "cpu"))


def train_batch(cfg):
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model_api as api
    return api.make_batch(cfg, InputShape(*TRAIN_SHAPE),
                          np.random.default_rng(0), device="cpu")


def train_config(arch):
    from repro_torch.configs.registry import get_config
    return get_config(arch).reduced()


def decode_config():
    return train_config("qwen3-0.6b").replace(decode_impl="shmap_flash")


def decode_inputs(cfg):
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT)))
    steps = [torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                           (DECODE_BATCH, 1)))
             for _ in range(DECODE_STEPS)]
    return prompt, steps


def moe_config(cf):
    return train_config("mixtral-8x7b").replace(
        n_experts=MOE_EXPERTS, capacity_factor=cf)


def moe_inputs(cfg):
    """Layer 0's MoE parameters (bf16) and x (bf16), from seeds."""
    from repro_torch.models import model_api as api
    g = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, g, "cpu")
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=MOE_X + (cfg.d_model,)) * 0.1).to(
        torch.bfloat16)
    return layer, x


def scan_inputs():
    """Inputs of the SSD scan (B,S,H,P / N) and the RG-LRU scan (B,S,W),
    f32, from a seed."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 4, 32, 8, 16, 16

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).float()

    ssd = (t(b, s, h, p), torch.nn.functional.softplus(t(b, s, h)),
           -torch.exp(t(h, scale=0.5)), t(b, s, 1, n), t(b, s, 1, n))
    a = torch.sigmoid(t(b, s, 64))
    return ssd, (a, t(b, s, 64))


def attn_inputs():
    """q (B,S,4,D), k/v (B,S,2,D), f32: the reduced configs' heads."""
    rng = np.random.default_rng(4)
    return tuple(torch.from_numpy(rng.normal(size=(4, 32, h, 32))).float()
                 for h in (4, 2, 2))


# --------------------------------------------------------------- ranks ----
def _full(tree):
    """numpy of every leaf, each DTensor gathered (on every rank)."""
    from repro_torch import sharding as shd
    from repro_torch.models import params as pm

    def one(t):
        if shd.is_dtensor(t):
            t = t.full_tensor()
        return t.detach().float().numpy() if torch.is_tensor(t) else t

    return pm.tree_map(one, tree)


def _placements(tree):
    from repro_torch import sharding as shd
    from repro_torch.models import params as pm
    return pm.tree_map(lambda t: tuple(map(str, t.placements))
                       if shd.is_dtensor(t) else None, tree)


def _want(tree):
    from repro_torch.models import params as pm
    return pm.tree_map(lambda s: tuple(map(str, s.placements)), tree)


def _train(mesh, archs=TRAIN_ARCHS, num_microbatches=1):
    from repro_torch import sharding as shd
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    out = {}
    oc = opt.OptConfig()
    for arch in archs:
        cfg = train_config(arch)
        specs = api.model_specs(cfg)
        p_sh = api.param_shardings(cfg, mesh)
        s_sh = opt.state_shardings(oc, specs, mesh)
        params = pm.distribute(f32_params(cfg), p_sh)
        state = pm.distribute(opt.init_state(oc, specs, device="cpu"), s_sh)
        batch = pm.distribute(train_batch(cfg), api.batch_shardings(
            cfg, mesh, InputShape(*TRAIN_SHAPE)))
        with shd.use_mesh(mesh):
            new_p, new_s, metrics = ts.make_train_step(
                cfg, oc, num_microbatches)(params, state, batch)
        out[arch] = {
            "params": _full(new_p), "state": _full(new_s),
            "metrics": _full(metrics),
            "placed": (_placements(new_p) == _want(p_sh)
                       and _placements(new_s) == _want(s_sh)),
        }
    return out


def _decode(mesh):
    from repro_torch import sharding as shd
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.models import transformer as tfm

    cfg = decode_config()
    params = f32_params(cfg)
    prompt, steps = decode_inputs(cfg)
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": prompt},
                               DECODE_PROMPT)
        cache = pm.distribute(cache, api.cache_shardings(
            cfg, mesh, DECODE_BATCH, DECODE_PROMPT))
        params = pm.distribute(params, api.param_shardings(cfg, mesh))
        calls = []
        orig = tfm._flash_decode_shmap

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        tfm._flash_decode_shmap = counted
        logits = []
        try:
            with shd.use_mesh(mesh):
                for tok in steps:
                    lg, cache = api.decode_step(cfg, params, cache,
                                                {"token": tok})
                    logits.append(_full(lg))
        finally:
            tfm._flash_decode_shmap = orig
    return {"logits": logits, "cache": _full(cache),
            "shmap_calls": len(calls)}


def _moe(mesh):
    from repro_torch import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models import params as pm

    out = {}
    for cf in MOE_FACTORS:
        cfg = moe_config(cf).replace(moe_impl="sorted_shmap")
        layer, x = moe_inputs(cfg)
        sh = pm.shardings(moe.moe_specs(cfg), mesh)
        layer = pm.distribute(layer, sh)
        x = shd.distribute(x, shd.named_sharding(mesh, x.shape,
                                                 ("batch", None, "embed")))
        calls = []
        orig = moe._group_sorted

        def counted(*a, **k):
            calls.append(shd.is_dtensor(a[4]))
            return orig(*a, **k)

        moe._group_sorted = counted
        try:
            with shd.use_mesh(mesh), torch.no_grad():
                y, aux = moe.moe_block(cfg, layer, x)
        finally:
            moe._group_sorted = orig
        # the local body ran on plain local tensors
        out[cf] = {"y": _full(y), "aux": _full(aux),
                   "local": calls == [False]}
    return out


def _kernels(mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import sharding as shd
    from repro_torch.kernels import ops

    def place(t, *pl):
        return shd.distribute(t, shd.NamedSharding(mesh, (), tuple(pl)))

    (x, dt, A, Bm, Cm), (a, b) = scan_inputs()
    q, k, v = attn_inputs()
    with shd.use_mesh(mesh):
        y, final = ops.ssd_scan(place(x, Shard(0), Shard(2)),
                                place(dt, Shard(0), Shard(2)), A,
                                place(Bm, Shard(0), Replicate()),
                                place(Cm, Shard(0), Replicate()), chunk=16)
        h = ops.rglru_scan(place(a, Shard(0), Shard(2)),
                           place(b, Shard(0), Shard(2)))
        # query heads sharded, kv heads replicated: each rank narrows
        ctx = ops.flash_attention(place(q, Shard(0), Shard(2)),
                                  place(k, Shard(0), Replicate()),
                                  place(v, Shard(0), Replicate()),
                                  q_block=16, kv_block=16)
        try:
            ops.rglru_scan(place(a, Shard(0), Shard(1)), b)
            seq_raises = False
        except ValueError:
            seq_raises = True
    return {"ssd": (_full(y), _full(final)), "rglru": _full(h),
            "attn": _full(ctx), "seq_raises": seq_raises,
            "placements": tuple(tuple(p.dim for p in t.placements)
                                for t in (y, final))}


def _checkpoint(meshes, directory):
    """qwen3's parameters and AdamW state placed on ``meshes[0]``, saved,
    and restored onto ``meshes[1]``."""
    from repro_torch import sharding as shd
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models import model_api as api
    from repro_torch.models import params as pm
    from repro_torch.train import optimizer as opt

    cfg = train_config("qwen3-0.6b")
    oc = opt.OptConfig()
    specs = api.model_specs(cfg)
    state = opt.init_state(oc, specs, device="cpu")
    state["m"] = pm.tree_map(lambda t: t + 0.25, state["m"])
    tree = {"params": f32_params(cfg), "opt": state}
    src, dst = meshes
    placed = {"params": pm.distribute(tree["params"],
                                      api.param_shardings(cfg, src)),
              "opt": pm.distribute(tree["opt"],
                                   opt.state_shardings(oc, specs, src))}
    ck = Checkpointer(directory)
    ck.save(3, placed)
    dst_sh = {"params": api.param_shardings(cfg, dst),
              "opt": opt.state_shardings(oc, specs, dst)}
    back = ck.restore(3, tree, shardings=dst_sh)
    placed_on_dst = all(t.device_mesh is dst for t in pm.tree_leaves(back))
    return {"saved": _full(tree), "restored": _full(back),
            "on_dst": placed_on_dst and _placements(back) == _want(dst_sh)}


def _rank(rank: int, directory: str) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_mesh
        meshes = {s: make_mesh(s, ("data", "model")) for s in MESHES}
        results = {}
        for s, mesh in meshes.items():
            results[s] = {"train": _train(mesh), "decode": _decode(mesh),
                          "moe": _moe(mesh), "kernels": _kernels(mesh)}
            if s == MB_MESH:
                results[s]["train_mb"] = _train(mesh, MB_ARCHS, MICROBATCHES)
        results["checkpoint"] = _checkpoint(
            (meshes[(2, 2)], meshes[(1, 4)]), os.path.join(directory, "ck"))
        if rank == 0:
            with open(os.path.join(directory, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_ranks() -> dict:
    """Spawn the four ranks once and return rank 0's results."""
    import torch.multiprocessing as mp
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    with tempfile.TemporaryDirectory() as directory:
        mp.spawn(_rank, args=(directory,), nprocs=WORLD, join=True)
        with open(os.path.join(directory, "results.pkl"), "rb") as f:
            return pickle.load(f)
