"""The port's training slice against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX
function and to its counterpart in ``mxnet_tpu_torch``; on CPU tensors
the port runs the plain PyTorch versions its CUDA kernels are held
against on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances, with their reasons:

- flash-attention gradients 2e-5 (float32; the same blockwise algorithm,
  only XLA's and PyTorch's summation orders differ);
- update rules rtol 1e-6 (the same elementwise float32 chain; Adam's
  ``beta ** t`` may differ by an ulp between XLA and PyTorch), and
  rtol/atol 1e-6 against the Pallas kernels in interpret mode, as the
  JAX package's own tests hold them;
- ``fused_bucket_rule`` and the Trainer's flat bucket: bitwise against
  the plain per-param rule (same elementwise functions over the same
  values);
- training Llama for 4 steps: losses within 1e-5 relative; parameters
  within 1e-6 for SGD and 5e-5 for Adam, whose ``m / sqrt(v)`` step is
  about ``lr`` in size wherever ``|g|`` is small, so a last-digit
  difference in a tiny gradient moves the parameter by a fraction of
  ``lr`` (5e-3).
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.llama import llama_tiny as jax_llama_tiny
from mxnet_tpu.ops import flash_attention as jax_flash
from mxnet_tpu.optimizer import fused_rule as jax_fused_rule

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, NotSupportedError
from mxnet_tpu_torch.convert import (llama_decode_weights_to_numpy,
                                     load_llama_decode_weights)
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import L2Loss, SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama_tiny
from mxnet_tpu_torch.ops.flash_attention import flash_attention
from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
from mxnet_tpu_torch.optimizer import create, fused_rule

nd = mx.nd
REPO = pathlib.Path(__file__).resolve().parents[1]
RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
         ("adam", {}), ("adamw", {"beta1": 0.8})]
RULE_IDS = ["sgd", "momentum", "nag", "adam", "adamw"]
TRAIN_CASES = {"adam": ("adam", {"learning_rate": 5e-3}, 5e-5),
               "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 1e-6)}
VOCAB, BATCH, SEQ = 256, 2, 16


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's torch work (restored
    after): the tier-1 run shares the host's cores among its workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree_to_numpy(tree):
    embed, norm, head, layers = tree
    return (np.asarray(embed), np.asarray(norm),
            None if head is None else np.asarray(head),
            [tuple(np.asarray(w) for w in layer) for layer in layers])


def _leaves(tree):
    embed, norm, head, layers = tree
    return [embed, norm] + ([] if head is None else [head]) + \
        [w for layer in layers for w in layer]


# ----------------------------------------------------------------------
# flash attention backward (K3 bwd)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,lq,lk", [
    (False, 16, 16), (True, 16, 16), (False, 128, 128), (True, 128, 128),
    (False, 200, 200), (True, 200, 200),
    # causal cross-attention lengths (top-left mask), one at a 64-row edge
    (True, 48, 96), (True, 130, 70), (True, 64, 129)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_grads_match_jax_grad(causal, lq, lk, D):
    """dq, dk, dv by torch autograd through the port's Function (the
    plain backward on the CPU) against ``jax.grad`` of the JAX op."""
    rng = np.random.RandomState(lq + lk + D + causal)
    q, g = (rng.randn(2, 3, lq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 3, lk, D).astype(np.float32) for _ in range(2))
    ref = jax.grad(lambda a, b, c: jnp.sum(
        jax_flash(a, b, c, causal=causal) * g), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=2e-5, atol=2e-5)


def test_flash_no_grad_keeps_output_detached():
    """The serving path's no-grad calls build no graph."""
    x = torch.randn(1, 2, 16, 64)
    with torch.no_grad():
        out = flash_attention(x, x, x, causal=True)
    assert out.grad_fn is None and not out.requires_grad


# ----------------------------------------------------------------------
# update rules (K1, K2)
# ----------------------------------------------------------------------

def _rule_run(name, hyper, steps=3, n=5000):
    """3 steps with clip and wd: the JAX rule (its caller pre-multiplies
    g by the rescale, as the Trainer does), the port's plain rule and
    the port's bucket rule (rescale folded in)."""
    rng = np.random.RandomState(6)
    p = rng.randn(n).astype(np.float32)
    grads = [rng.randn(n).astype(np.float32) for _ in range(steps)]
    ji, ja = jax_fused_rule(name, clip_gradient=0.5, **hyper)
    _, pa = fused_rule(name, clip_gradient=0.5, **hyper)
    bi, ba = fused_bucket_rule(name, clip_gradient=0.5, **hyper)
    jp, js = jnp.asarray(p), ji(jnp.asarray(p))
    tp, ts = torch.from_numpy(p.copy()), bi(torch.from_numpy(p.copy()))
    bp, bs = tp.clone(), {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in ts.items()}
    for g in grads:
        jp, js = ja(jp, jnp.asarray(g) * np.float32(0.5), js,
                    jnp.float32(0.01), jnp.float32(1e-3))
        tp, ts = pa(tp, torch.from_numpy(g), ts, 0.01, 1e-3, 0.5)
        bp, bs = ba(bp, torch.from_numpy(g), bs, 0.01, 1e-3, 0.5)
    return (p, grads), (jp, js), (tp, ts), (bp, bs)


@pytest.mark.parametrize("name,hyper", RULES, ids=RULE_IDS)
def test_fused_rule_matches_jax(name, hyper):
    _, (jp, js), (tp, ts), _ = _rule_run(name, hyper)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    for leaf, val in ts.items():
        if torch.is_tensor(val):
            np.testing.assert_allclose(val.numpy(), np.asarray(js[leaf]),
                                       rtol=1e-6)
        else:
            assert val == int(js[leaf])


@pytest.mark.parametrize("name,hyper", RULES, ids=RULE_IDS)
def test_fused_bucket_rule_cpu_is_fused_rule_bitwise(name, hyper):
    _, _, (tp, ts), (bp, bs) = _rule_run(name, hyper)
    assert torch.equal(tp, bp)
    assert set(ts) == set(bs)
    for leaf in ts:
        if torch.is_tensor(ts[leaf]):
            assert torch.equal(ts[leaf], bs[leaf]), leaf
        else:
            assert ts[leaf] == bs[leaf]


_PALLAS_SCRIPT = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
import mxnet_tpu.ops.fused_update as fu
from mxnet_tpu.optimizer import fused_rule
rules, out_path = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for name, hyper in rules:
    rng = np.random.RandomState(6)
    p = jnp.asarray(rng.randn(5000).astype(np.float32))
    s = fused_rule(name, **hyper)[0](p)
    for _ in range(3):
        g = jnp.asarray(rng.randn(5000).astype(np.float32)) * np.float32(0.5)
        if name in ("sgd", "nag"):
            p, s = fu._pallas_sgd(p, g, s, 0.01, 1e-3,
                                  hyper.get("momentum", 0.0), name == "nag",
                                  0.5, interpret=True)
        else:
            p, s = fu._pallas_adam(p, g, s, 0.01, 1e-3,
                                   hyper.get("beta1", 0.9), 0.999, 1e-8,
                                   name == "adamw", 0.5, interpret=True)
    res[name + json.dumps(hyper, sort_keys=True)] = np.asarray(p)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def pallas_rule_results(tmp_path_factory):
    """The reference's Pallas bucket kernels (K1, K2) run in interpret
    mode on ``_rule_run``'s inputs, in a child process: this test
    process pins JAX to the CPU backend, where the Pallas TPU lowering
    rules cannot register."""
    out = tmp_path_factory.mktemp("pallas") / "rules.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", _PALLAS_SCRIPT,
         json.dumps(RULES), str(out)],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name,hyper", RULES, ids=RULE_IDS)
def test_fused_rule_matches_jax_pallas_interpret(pallas_rule_results, name,
                                                 hyper):
    """The port's rule against the reference's Pallas bucket kernels
    run in interpret mode, 3 steps with clip and wd."""
    _, _, (tp, _), _ = _rule_run(name, hyper)
    ref = pallas_rule_results[name + json.dumps(hyper, sort_keys=True)]
    np.testing.assert_allclose(tp.numpy(), ref, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (4, 5))
    ref = jgluon.loss.SoftmaxCrossEntropyLoss()(nd.array(logits),
                                                nd.array(labels))
    got = SoftmaxCrossEntropyLoss()(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), ref.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    pred, y = rng.randn(6, 3).astype(np.float32), \
        rng.randn(6, 3).astype(np.float32)
    ref = jgluon.loss.L2Loss()(nd.array(pred), nd.array(y))
    got = L2Loss()(torch.from_numpy(pred), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref.asnumpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# Trainer + Llama: the slice as a whole
# ----------------------------------------------------------------------

def _batch():
    tokens = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    labels = np.random.RandomState(1).randint(0, VOCAB, (BATCH * SEQ,))
    return tokens, labels


def _port_step(net, trainer, tokens, labels):
    logits = net(torch.from_numpy(tokens))
    loss = SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                     torch.from_numpy(labels)).mean()
    loss.backward()
    trainer.step(BATCH)
    return float(loss.detach())


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def trained(request):
    """JAX ``llama_tiny(num_layers=1)`` trained 4 steps by the reference's
    ``gluon.Trainer``, and the port from the same weights (carried across
    by ``convert``)."""
    optname, args, atol = TRAIN_CASES[request.param]
    jnet = jax_llama_tiny(num_layers=1)
    jnet.initialize()
    tokens, labels = _batch()
    jnet(nd.array(tokens))
    pnet = load_llama_decode_weights(
        llama_tiny(num_layers=1, device="cpu", seed=None),
        _tree_to_numpy(jnet.decode_weights()))
    jtr = jgluon.Trainer(jnet.collect_params(), optname, dict(args))
    ptr = Trainer(dict(pnet.named_parameters()), optname, dict(args))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    jl, pl = [], []
    for _ in range(4):
        with autograd.record():
            out = jnet(nd.array(tokens))
            loss = jloss_fn(out.reshape((-1, VOCAB)),
                            nd.array(labels)).mean()
        loss.backward()
        jtr.step(BATCH)
        jl.append(float(loss.asnumpy()))
        pl.append(_port_step(pnet, ptr, tokens, labels))
    return dict(jax_losses=jl, port_losses=pl, atol=atol, trainer=ptr,
                jax_w=_tree_to_numpy(jnet.decode_weights()),
                port_w=llama_decode_weights_to_numpy(pnet))


def test_llama_training_matches_jax(trained):
    np.testing.assert_allclose(trained["port_losses"],
                               trained["jax_losses"], rtol=1e-5)
    assert trained["port_losses"][-1] < trained["port_losses"][0]
    for got, want in zip(_leaves(trained["port_w"]),
                         _leaves(trained["jax_w"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=trained["atol"])


def test_llama_training_took_the_flat_bucket(trained):
    tr = trained["trainer"]
    assert tr._bucket_apply is not None
    assert set(tr._optimizer._index_update_count.values()) == {4}


# ----------------------------------------------------------------------
# grad_req="write": two backward passes before one step keep the last
# ----------------------------------------------------------------------

def _second_batch():
    tokens = np.random.RandomState(2).randint(0, VOCAB, (BATCH, SEQ))
    labels = np.random.RandomState(3).randint(0, VOCAB, (BATCH * SEQ,))
    return tokens, labels


def _port_loss(net, tokens, labels):
    logits = net(torch.from_numpy(tokens))
    return SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                     torch.from_numpy(labels)).mean()


@pytest.mark.parametrize("optname", sorted(TRAIN_CASES))
def test_two_backward_passes_then_step_match_jax(optname):
    """Backward on two batches, then one ``step``: the reference's default
    ``grad_req="write"`` keeps the second gradient; so does the port."""
    _, args, atol = TRAIN_CASES[optname]
    jnet = jax_llama_tiny(num_layers=1)
    jnet.initialize()
    batches = [_batch(), _second_batch()]
    jnet(nd.array(batches[0][0]))
    pnet = load_llama_decode_weights(
        llama_tiny(num_layers=1, device="cpu", seed=None),
        _tree_to_numpy(jnet.decode_weights()))
    jtr = jgluon.Trainer(jnet.collect_params(), optname, dict(args))
    ptr = Trainer(dict(pnet.named_parameters()), optname, dict(args))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    for tokens, labels in batches:
        with autograd.record():
            out = jnet(nd.array(tokens))
            loss = jloss_fn(out.reshape((-1, VOCAB)),
                            nd.array(labels)).mean()
        loss.backward()
        _port_loss(pnet, tokens, labels).backward()
    jtr.step(BATCH)
    ptr.step(BATCH)
    for got, want in zip(_leaves(llama_decode_weights_to_numpy(pnet)),
                         _leaves(_tree_to_numpy(jnet.decode_weights()))):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_two_backward_passes_equal_the_last_alone_bitwise():
    """The port alone: backward on the first and the second batch, then
    a step, gives the bits of one backward on the second batch."""
    nets = [llama_tiny(num_layers=1, device="cpu", seed=7) for _ in range(2)]
    trainers = [Trainer(dict(n.named_parameters()), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
                for n in nets]
    _port_loss(nets[0], *_batch()).backward()
    for net, tr in zip(nets, trainers):
        _port_loss(net, *_second_batch()).backward()
        tr.step(BATCH)
    for (name, a), (_, b) in zip(nets[0].named_parameters(),
                                 nets[1].named_parameters()):
        assert torch.equal(a, b), name


def test_tied_use_within_one_backward_still_sums():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    tr = Trainer([w], "sgd", {"learning_rate": 0.1})
    (2 * w + 3 * w).sum().backward()
    torch.testing.assert_close(w.grad, torch.tensor([5.0, 5.0]))
    (7 * w).sum().backward()
    torch.testing.assert_close(w.grad, torch.tensor([7.0, 7.0]))
    tr.step(1)
    assert w.grad is None


def test_autograd_grad_leaves_dot_grad_alone():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    tr = Trainer([w], "sgd", {"learning_rate": 0.1})
    (3 * w).sum().backward()
    (g,) = torch.autograd.grad((11 * w).sum(), w)
    torch.testing.assert_close(g, torch.tensor([11.0, 11.0]))
    torch.testing.assert_close(w.grad, torch.tensor([3.0, 3.0]))
    tr.step(1)
    torch.testing.assert_close(w.detach(), torch.tensor([0.7, -2.3]))


@pytest.mark.parametrize("optname,args", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.01}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.1, "clip_gradient": 0.01})])
@pytest.mark.parametrize("buffer", [True, False], ids=["buffer", "gather"])
def test_trainer_flat_bucket_equals_per_param_bitwise(monkeypatch, optname,
                                                      args, buffer):
    """The Trainer's one flat-bucket update against the per-param path
    (``Optimizer.update`` over each parameter with its own state): with
    the parameters as views of the persistent flat buffer, updated where
    they lie, and without it (the buffer's construction switched off),
    gathered into a bucket and written back."""
    if not buffer:
        monkeypatch.setattr(Trainer, "_build_param_buffer", lambda self: None)
    tokens, labels = _batch()
    flat_net = llama_tiny(num_layers=1, device="cpu", seed=5)
    ref_net = llama_tiny(num_layers=1, device="cpu", seed=5)
    trainer = Trainer(dict(flat_net.named_parameters()), optname, dict(args))
    assert (trainer._flat_param is not None) == buffer
    ref_opt = create(optname, **args)
    ref_params = [p for _, p in sorted(ref_net.named_parameters())]
    ref_states = {i: ref_opt.create_state(i, p.detach())
                  for i, p in enumerate(ref_params)}
    for _ in range(3):
        _port_step(flat_net, trainer, tokens, labels)
        logits = ref_net(torch.from_numpy(tokens))
        SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                  torch.from_numpy(labels)).mean().backward()
        ref_opt.rescale_grad = 1.0 / BATCH
        for i, p in enumerate(ref_params):
            ref_opt.update(i, p, p.grad, ref_states[i])
            p.grad = None
    assert trainer._bucket_apply is not None
    for (name, a), (_, b) in zip(sorted(flat_net.named_parameters()),
                                 sorted(ref_net.named_parameters())):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("optname,args,flat_steps", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2),
    ("adam", {"learning_rate": 1e-3}, 1)])
def test_trainer_flat_bucket_skips_stale_params(monkeypatch, optname, args,
                                                flat_steps):
    """With ``ignore_stale_grad`` a parameter without a gradient is left
    alone and the fresh ones still update as one flat bucket; the next,
    full step goes flat again when the optimizer's host scalars agree
    (SGD has none) and per-param when they do not (Adam's step counts
    now differ), as the reference decides.  Both steps bitwise equal to
    ``Optimizer.update`` over each parameter with the same skip."""
    import mxnet_tpu_torch.gluon.trainer as trainer_mod
    calls = []

    def counting_rule(*a, **kw):
        init, apply = fused_bucket_rule(*a, **kw)

        def counted(p, *rest):
            calls.append(p.numel())
            return apply(p, *rest)
        return init, counted
    monkeypatch.setattr(trainer_mod, "fused_bucket_rule", counting_rule)
    tokens, labels = _batch()
    net = llama_tiny(num_layers=1, device="cpu", seed=2)
    ref_net = llama_tiny(num_layers=1, device="cpu", seed=2)
    params = dict(net.named_parameters())
    trainer = Trainer(params, optname, dict(args))
    ref_opt = create(optname, **args)
    ref_params = [p for _, p in sorted(ref_net.named_parameters())]
    ref_states = {i: ref_opt.create_state(i, p.detach())
                  for i, p in enumerate(ref_params)}
    frozen = "model.norm.weight"
    frozen_idx = sorted(params).index(frozen)
    before = params[frozen].detach().clone()
    for step in range(2):
        for model in (net, ref_net):
            logits = model(torch.from_numpy(tokens))
            SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                      torch.from_numpy(labels)).mean() \
                .backward()
        if step == 0:
            params[frozen].grad = None
            trainer.step(BATCH, ignore_stale_grad=True)
            assert torch.equal(params[frozen], before)
        else:
            trainer.step(BATCH)
        ref_opt.rescale_grad = 1.0 / BATCH
        for i, p in enumerate(ref_params):
            if not (step == 0 and i == frozen_idx):
                ref_opt.update(i, p, p.grad, ref_states[i])
            p.grad = None
        assert all(p.grad is None for p in params.values())
    total = sum(p.numel() for p in params.values())
    assert calls == [total - before.numel(), total][:flat_steps]
    for (name, a), (_, b) in zip(sorted(net.named_parameters()),
                                 sorted(ref_net.named_parameters())):
        assert torch.equal(a, b), name


def test_whole_group_update_runs_on_the_parameter_buffer(monkeypatch):
    """Every trainable f32 parameter is a view of one flat buffer, in the
    Trainer's order; a step over the whole group hands that buffer to
    the bucket rule (no gather of the parameters) and the views see the
    update."""
    import mxnet_tpu_torch.gluon.trainer as trainer_mod
    seen = []

    def recording_rule(*a, **kw):
        init, apply = fused_bucket_rule(*a, **kw)

        def recorded(p, *rest):
            seen.append(p)
            return apply(p, *rest)
        return init, recorded
    monkeypatch.setattr(trainer_mod, "fused_bucket_rule", recording_rule)
    net = llama_tiny(num_layers=1, device="cpu", seed=6)
    params = dict(net.named_parameters())
    trainer = Trainer(params, "adamw", {"learning_rate": 1e-3, "wd": 0.1})
    buf = trainer._flat_param
    off = 0
    for name in sorted(params):
        p = params[name]
        assert p.data_ptr() == buf.data_ptr() + 4 * off, name
        off += p.numel()
    assert off == buf.numel()
    before = buf.clone()
    _port_step(net, trainer, *_batch())
    assert len(seen) == 1 and seen[0] is buf
    assert not torch.equal(before, buf)
    torch.testing.assert_close(
        torch.cat([params[k].detach().reshape(-1) for k in sorted(params)]),
        buf, rtol=0, atol=0)


def test_parameter_buffer_survives_load_state_dict():
    """``load_state_dict`` copies into the parameters in place: they stay
    views of the buffer, and the next step updates the loaded values
    exactly as a Trainer built on them does."""
    net = llama_tiny(num_layers=1, device="cpu", seed=7)
    trainer = Trainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    ptrs = [p.data_ptr() for _, p in sorted(net.named_parameters())]
    loaded = llama_tiny(num_layers=1, device="cpu", seed=8)
    net.load_state_dict(loaded.state_dict())
    assert [p.data_ptr() for _, p in sorted(net.named_parameters())] == ptrs
    fresh = Trainer(dict(loaded.named_parameters()), "sgd",
                    {"learning_rate": 0.1, "momentum": 0.9})
    for model, tr in ((net, trainer), (loaded, fresh)):
        _port_step(model, tr, *_batch())
    for (name, a), (_, b) in zip(sorted(net.named_parameters()),
                                 sorted(loaded.named_parameters())):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("move", ["rebind", "to-double"])
def test_parameter_moved_off_the_buffer_is_detected(move):
    """A parameter whose storage was replaced no longer lies in the
    buffer: the next step raises, naming it, and updates nothing."""
    net = llama_tiny(num_layers=1, device="cpu", seed=9)
    params = dict(net.named_parameters())
    trainer = Trainer(params, "sgd", {"learning_rate": 0.1})
    buf = trainer._flat_param.clone()
    if move == "rebind":
        params["lm_head.weight"].data = params["lm_head.weight"].data.clone()
        name = "lm_head.weight"
    else:
        net.to(torch.float64)
        name = sorted(params)[0]
    _port_loss(net, *_batch()).backward()
    with pytest.raises(MXNetError, match=f"`{name}`.*flat parameter buffer"):
        trainer.step(BATCH)
    assert torch.equal(trainer._flat_param, buf)


def test_engine_built_before_the_trainer_refuses_to_serve():
    """A Trainer moves the net's parameters into its flat buffer, so an
    InferenceEngine built on the net before it would read the old
    storage: it raises at warmup and prefill instead of serving stale
    weights.  An engine built after the Trainer reads the buffer itself
    and serves each step's update."""
    from mxnet_tpu_torch.serving import InferenceEngine
    kw = dict(max_batch=2, block_size=16, max_context=32, device="cpu")
    net = llama_tiny(num_layers=1, device="cpu", seed=10)
    early = InferenceEngine(net, **kw)
    early.prefill(0, [1, 2, 3])
    trainer = Trainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": 0.5})
    for call in (early.warmup, lambda: early.prefill(1, [1, 2, 3])):
        with pytest.raises(MXNetError, match="InferenceEngine was built"):
            call()
    late = InferenceEngine(net, **kw)
    assert late.params["embed"].data_ptr() == \
        net.model.embed.weight.data_ptr()
    _, before = late.prefill(0, [1, 2, 3])
    _port_step(net, trainer, *_batch())
    _, after = late.prefill(1, [1, 2, 3])
    assert not torch.equal(before, after)


def test_stale_grad_step_raises_naming_the_parameter():
    net = llama_tiny(num_layers=1, device="cpu", seed=3)
    params = dict(net.named_parameters())
    trainer = Trainer(params, "adam", {"learning_rate": 1e-3})
    tokens, labels = _batch()
    _port_step(net, trainer, tokens, labels)
    before = {k: p.detach().clone() for k, p in params.items()}
    with pytest.raises(MXNetError, match="`lm_head.weight`"):
        trainer.step(BATCH)
    assert all(torch.equal(p, before[k]) for k, p in params.items())
    trainer.step(BATCH, ignore_stale_grad=True)   # nothing to update


def test_unported_optimizers_and_kvstores_raise():
    p = {"w": torch.nn.Parameter(torch.zeros(3))}
    for name in ("lamb", "rmsprop", "adagrad"):
        with pytest.raises(NotSupportedError, match="training-surface"):
            Trainer(p, name)
    # lr_scheduler and multi_precision are ported now: taken as the
    # reference takes them (test_torch_port_amp.py holds their numbers)
    sched = mt.optimizer.lr_scheduler.FactorScheduler(step=2)
    tr = Trainer(p, "sgd", {"lr_scheduler": sched, "multi_precision": True,
                            "learning_rate": 0.3})
    assert tr.optimizer.lr_scheduler is sched and sched.base_lr == 0.3
    assert tr.optimizer.multi_precision
    for kv in ("dist_sync", "nccl", "tpu_sync"):
        with pytest.raises(NotSupportedError, match="multi-device"):
            Trainer(p, "sgd", kvstore=kv)
    with pytest.raises(MXNetError):
        Trainer([torch.zeros(3)], "sgd")
    tr = Trainer(p, "sgd", {"learning_rate": 0.5}, kvstore="local")
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25 and isinstance(tr.optimizer,
                                                   mt.optimizer.SGD)


@pytest.mark.parametrize("trainer_kw,opt_kw,refused", [
    ({"compression_params": None, "update_on_kvstore": None}, {}, None),
    ({}, {"lazy_update": False}, None),
    ({}, {"lazy_update": True, "param_idx2name": {}, "sym": None,
          "param_dict": None}, None),
    ({"compression_params": {"type": "2bit"}}, {}, "multi-device"),
    ({"update_on_kvstore": False}, {}, "multi-device"),
    ({}, {"param_idx2name": {0: "w"}}, "training-surface"),
    ({}, {"sym": object()}, "training-surface"),
    ({}, {"param_dict": {0: types.SimpleNamespace(lr_mult=1.0,
                                                  wd_mult=1.0)}}, None)],
    ids=["kvstore-defaults", "lazy-update", "optimizer-defaults",
         "compression", "update-on-kvstore", "param-idx2name", "sym",
         "param-dict"])
@pytest.mark.parametrize("optname", ["sgd", "adam"])
def test_reference_arguments_accepted_or_refused_by_name(
        optname, trainer_kw, opt_kw, refused):
    """The reference's Trainer and Optimizer arguments: the no-op defaults
    (and ``lazy_update``, dense here as in the reference) update like the
    plain call; anything else raises ``NotSupportedError`` naming its
    ROADMAP item."""
    def run(tkw, okw):
        p = {"w": torch.nn.Parameter(torch.linspace(-1, 1, 6))}
        tr = Trainer(p, optname, {"learning_rate": 0.1, **okw}, **tkw)
        p["w"].grad = torch.linspace(0.5, -0.5, 6)
        tr.step(2)
        return p["w"].detach()

    if refused:
        with pytest.raises(NotSupportedError, match=refused) as err:
            run(trainer_kw, opt_kw)
        assert "ROADMAP §1 item" in str(err.value)
    else:
        assert torch.equal(run(trainer_kw, opt_kw), run({}, {}))
