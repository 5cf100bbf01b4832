"""The parallel train steps of the PyTorch port on a (data, model) mesh of
gloo CPU ranks vs the JAX package on the conftest's 8 virtual devices,
from one state and with JAX's own draws of t and the noise over the
global batch (``__graft_entry__._dryrun_dit`` / ``_dryrun_lora_tp``'s
tiny DiT and batch): the full fine-tune step with TP and DP against
``make_dit_train_step`` under the mesh and the logical rules, the DP step
against ``make_parallel_dit_train_step``, and the TP LoRA step against
``make_lora_train_step`` under the rules. Loss, grad_norm, and the
updated parameters or adapters gathered from the model ranks."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.models.cogvideox import transformer as jtr
from langscenex_tpu.parallel import mesh as jmesh
from langscenex_tpu.train import dit as jdit
from langscenex_tpu.train import lora as jlora
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models.cogvideox import transformer as tr
from langscenex_tpu_torch.parallel import dryrun
from langscenex_tpu_torch.train import dit, lora

# __graft_entry__._dryrun_dit's DiT (remat on), a 2-sample global batch;
# lr 1e-3 so that the second step (the first is at lr 0) moves the weights
TINY = dict(num_layers=1, num_heads=4, head_dim=16, in_channels=8,
            out_channels=4, patch_size=2, text_embed_dim=16,
            time_embed_dim=32, remat=True)
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0)
KEYS = (2, 3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(seed):
    model = jtr.CogVideoXTransformer(jtr.TransformerConfig(
        attn_dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(seed)
    batch = {"x0": rng.normal(size=(2, 2, 4, 4, 4)).astype(np.float32),
             "cond": rng.normal(size=(2, 2, 4, 4, 4)).astype(np.float32),
             "text": rng.normal(size=(2, 3, 16)).astype(np.float32)}
    lat = np.concatenate([batch["x0"], batch["cond"]], axis=2)
    params = model.init(jax.random.PRNGKey(0), lat, batch["text"],
                        np.zeros(2, np.int32))["params"]
    return model, params, batch


def _draws(key, shape):
    """The global t and noise that the JAX step draws from ``key``."""
    rt, rn = jax.random.split(jax.random.PRNGKey(key))
    return (np.asarray(jax.random.randint(rt, (shape[0],), 0, 1000)),
            np.asarray(jax.random.normal(rn, shape, jnp.float32)))


def _port(shape, params, batch, tmp_path, *lora_args):
    """The port's steps on a spawned mesh of ``shape`` from the JAX
    params, with JAX's draws; ``lora_args`` = (full adapters, LoRAConfig)
    for the LoRA step."""
    tcfg = tr.TransformerConfig(attn_dtype=torch.float32, **TINY)
    sd = {k: v.numpy() for k, v in convert.cogvideox_dit_from_numpy(
        _np_tree(params), head_dim=16, device="cpu").items()}
    draws = [_draws(k, batch["x0"].shape) for k in KEYS]
    return dryrun.spawn(dryrun.train_rank, shape[0] * shape[1],
                        (shape, "cpu", tcfg, sd, batch, draws,
                         dit.DiTTrainConfig(**TCFG), *lora_args),
                        workdir=str(tmp_path))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, f"{prefix}/{k}").items()}


def _gathered(res, gather):
    """The model ranks' shards of data rank 0, gathered; every data rank
    holds the same shard (exactly)."""
    by_pos = {r["position"]: _tensors(r["shard"]) for r in res}
    n_model = 1 + max(m for _, m in by_pos)
    assert len(by_pos) == len(res)
    for (d, m), shard in by_pos.items():
        ref = _flat(by_pos[(0, m)])
        for k, v in _flat(shard).items():
            assert torch.equal(v, ref[k]), (d, m, k)
    return gather([by_pos[(0, m)] for m in range(n_model)])


def _close_metrics(res, jm):
    # f32; the JAX CPU attention is the max-subtracted softmax as the
    # port's under TP, sums in another order: loss and grad_norm 1e-4
    for r in res:
        for a, b in zip(r["metrics"], jm):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_full_finetune_step_matches_jax(tmp_path, shape):
    # (2, 2): TP and DP against make_dit_train_step under the mesh and
    # DIT_LOGICAL_RULES; (2, 1): the DP step against
    # make_parallel_dit_train_step. Two steps with JAX's draws; Adam moves
    # a parameter by about lr = 1e-3 in the direction g / |g|, exact to
    # 1e-4 except where g is near 0: the gathered parameters within
    # 5e-6 + 1e-4 relative (tests/test_torch_dit_train.py's bounds)
    model, params, batch = _setup(1)
    jm = jmesh.make_mesh(n_data=shape[0], n_model=shape[1])
    cfg = jdit.DiTTrainConfig(**TCFG)
    if shape[1] > 1:
        init_state, step = jdit.make_dit_train_step(model, cfg)
        step = jax.jit(step)
    else:
        init_state, step = jdit.make_parallel_dit_train_step(model, jm, cfg)
    metrics = []
    with jm, nn.logical_axis_rules(jmesh.DIT_LOGICAL_RULES):
        state = init_state(params)
        jb = jmesh.shard_batch_tree(
            jax.tree_util.tree_map(jnp.asarray, batch), jm)
        for k in KEYS:
            state, m = step(state, jb, jax.random.PRNGKey(k))
            metrics.append({n: float(v) for n, v in m.items()})
    res = _port(shape, params, batch, tmp_path)
    _close_metrics(res, metrics)
    got = _gathered(res, convert.gather_dit_state_dict)
    want = convert.cogvideox_dit_from_numpy(_np_tree(state["params"]),
                                            head_dim=16, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=5e-6, rtol=1e-4,
                                   msg=k)


def test_tp_lora_step_matches_jax(tmp_path):
    # _dryrun_lora_tp's setup with nonzero adapters (B = 0.02 + init) on
    # (data=2, model=2): A whole and B split at the column-parallel sites,
    # A split and B whole at the row-parallel ones; two steps with JAX's
    # draws, bounds as the full step's
    model, params, batch = _setup(3)
    jm = jmesh.make_mesh(n_data=2, n_model=2)
    cfg, lcfg = jdit.DiTTrainConfig(**TCFG), jlora.LoRAConfig(rank=4)
    init_state, step = jlora.make_lora_train_step(model, params, cfg, lcfg)
    step = jax.jit(step)
    metrics = []
    with jm, nn.logical_axis_rules(jmesh.DIT_LOGICAL_RULES):
        state = init_state(jax.random.PRNGKey(1))
        state["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02,
                                               state["lora"])
        state["opt"] = jdit.make_optimizer(cfg).init(state["lora"])
        start = convert.lora_from_numpy(_np_tree(state["lora"]),
                                        head_dim=16, device="cpu")
        jb = jmesh.shard_batch_tree(
            jax.tree_util.tree_map(jnp.asarray, batch), jm)
        for k in KEYS:
            state, m = step(state, jb, jax.random.PRNGKey(k), params)
            metrics.append({n: float(v) for n, v in m.items()})
    full = {s: {k: v.numpy() for k, v in ab.items()}
            for s, ab in start.items()}
    res = _port((2, 2), params, batch, tmp_path, full,
                lora.LoRAConfig(rank=4))
    _close_metrics(res, metrics)
    got = _gathered(res, convert.gather_lora)
    want = convert.lora_from_numpy(_np_tree(state["lora"]), head_dim=16,
                                   device="cpu")
    moved = 0.0
    for site, ab in want.items():
        for k in ab:
            torch.testing.assert_close(got[site][k], ab[k], atol=5e-6,
                                       rtol=1e-4, msg=f"{site}/{k}")
            moved = max(moved, float((ab[k] - start[site][k]).abs().max()))
    assert moved > 1e-4
