"""The plain reference against the program (``repro_torch``) at small sizes
on the CPU, on the benchmark's own weights: the prefill's last logits in
f32 (the program with f32 weights), no choice dropped; decode steps
through the program's bf16 cache; the fp8 control apart from both. And the
weights' layout against the program's parameter tree."""
import numpy as np
import pytest
import torch

from portbench import harness, reference, small, weights

CONFIGS = ("qwen3-0.6b", "mixtral-8x7b-16l")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program(cfg):
    from repro_torch.models import model_api as api
    return api, harness.program_config(cfg)


def flat(tree, prefix=""):
    """Dotted name -> leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def f32_tree(cfg, seed):
    bf = weights.make(cfg, seed, "cpu")
    return {k: (v.float() if not isinstance(v, dict) else
                {kk: (vv.float() if not isinstance(vv, dict) else
                      {a: b.float() for a, b in vv.items()})
                 for kk, vv in v.items()})
            for k, v in bf.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_program_tree(name):
    cfg = small.config(name)
    api, pcfg = program(cfg)
    want = flat(api.abstract_params(pcfg))
    got = flat(weights.make(cfg, 1, "cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_full_size_configs_agree_with_the_program():
    for name in CONFIGS:
        cfg = harness.load(harness.HERE / "configs" / f"{name}.json")
        pcfg = harness.program_config(cfg)
        assert pcfg.num_layers == cfg["num_hidden_layers"]


@pytest.mark.parametrize("key,value", [("rms_norm_eps", 1e-5),
                                       ("hidden_size", 2048)])
def test_a_config_the_program_does_not_run_is_refused(key, value):
    cfg = dict(harness.load(harness.HERE / "configs" /
                            "mixtral-8x7b-16l.json"), **{key: value})
    with pytest.raises(ValueError, match=key):
        harness.program_config(cfg)


def test_a_capacity_that_can_drop_is_refused():
    cfg = harness.load(harness.HERE / "configs" / "mixtral-8x7b-16l.json")
    cfg["program"]["replace"] = {"num_layers": 16, "capacity_factor": 1.25}
    with pytest.raises(ValueError, match="drops_nothing"):
        harness.program_config(cfg)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n,pad", [(37, 64), (64, 64), (100, 128)])
def test_prefill_logits_match_in_f32(name, n, pad):
    cfg = small.config(name)
    api, pcfg = program(cfg)
    tree = f32_tree(cfg, 3)
    rng = np.random.default_rng(n)
    prompt = rng.integers(0, cfg["vocab_size"], n)
    tokens = np.zeros((1, pad), np.int64)
    tokens[0, :n] = prompt
    batch = {"tokens": torch.from_numpy(tokens),
             "prompt_lens": torch.tensor([n], dtype=torch.int32)}
    with torch.inference_mode():
        got, _ = api.prefill(pcfg.replace(dtype="float32"), tree, batch, 256)
    ref = reference.Reference(cfg, tree)
    want = ref.logits([torch.from_numpy(prompt)], [n])[0]
    assert want.shape == (1, cfg["vocab_size"])
    scale = want.abs().max()
    assert torch.allclose(got[0, -1].float(), want[0], atol=2e-4 * scale,
                          rtol=0)
    if name.startswith("mixtral"):
        assert ref.margins[0].shape == (1,)


def test_no_choice_drops_at_the_configured_capacity():
    """A prompt of one repeated token routes every position alike: at the
    configuration's capacity the program takes every choice and agrees with
    the reference (which drops nothing); at the program's default capacity
    (1.25) it drops choices and the logits part."""
    cfg = small.config("mixtral-8x7b-16l")
    api, pcfg = program(cfg)
    tree = f32_tree(cfg, 5)
    n = 128
    prompt = torch.full((n,), 7, dtype=torch.int64)
    want = reference.Reference(cfg, tree).logits([prompt], [n])[0]
    scale = want.abs().max()
    for cf, agree in ((pcfg.capacity_factor, True), (1.25, False)):
        with torch.inference_mode():
            got, _ = api.prefill(pcfg.replace(capacity_factor=cf), tree,
                                 {"tokens": prompt[None]}, 256)
        assert torch.allclose(got[0, -1].float(), want[0],
                              atol=2e-4 * scale, rtol=0) == agree, cf


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_through_the_cache_follows_the_reference(name):
    """Greedy decode on the program's bf16 weights and cache: every served
    token within a small gap of the reference's best, and the fp8 control
    further off."""
    cfg = small.config(name)
    api, pcfg = program(cfg)
    tree = weights.make(cfg, 7, "cpu")
    n, steps = 40, 12
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], n))
    with torch.inference_mode():
        logits, cache = api.prefill(pcfg, tree, {"tokens": prompt[None]},
                                    128)
        out = [int(logits[0, -1].argmax())]
        for _ in range(steps):
            logits, cache = api.decode_step(
                pcfg, tree, cache, {"token": torch.tensor([[out[-1]]])})
            out.append(int(logits[0, -1].argmax()))
    seq = torch.cat([prompt, torch.tensor(out[:-1])])
    ref = reference.Reference(cfg, tree)
    want = ref.logits([seq], [n])[0]
    tau = harness.load(harness.HERE / "cells" /
                       f"{name}.chat.json")["limits"].get("route_margin", 0)
    gaps = reference.served_gaps(want, torch.tensor(out), ref.margins[0],
                                 tau)
    assert gaps.numel() >= (steps + 1) // 2
    assert float(gaps.max()) < 0.1
    low = reference.Reference(cfg, tree, precision="fp8").logits(
        [seq], [n])[0]
    assert (low - want).abs().max() > 10 * (
        want - want.round(decimals=2)).abs().max()
