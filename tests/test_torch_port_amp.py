"""The port's mixed precision, schedules and ``multi_precision`` against
the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX
package and to ``mxnet_tpu_torch``; Llama's weights are carried across
by ``convert``.  ``amp.init()`` is process-wide in both packages, so
every test that switches it on does so through the ``amp_bf16`` /
``amp_fp16`` fixtures, whose teardown undoes both policies
(``_deinit_for_tests``) whatever the test did.

Tolerances, with their reasons:

- bf16 AMP training of ``llama_tiny`` for 4 steps: losses within
  2**-6 absolute, one bf16 spacing between 4 and 8 (two between 2 and
  4): both packages round the loss to bf16 after a bf16 log-softmax, so
  two f32 losses a hair apart may round to neighbouring values.  The
  parameters are held by their UPDATE, ``p4 - p0``, leaf by leaf, as
  ``|dp_port - dp_jax| / |dp_jax|`` (Frobenius norms), never by the
  parameters themselves, which move by little more than the
  disagreement.  The reference's attention takes f32 q and k where the
  port rounds them to bf16 after RoPE (a standing difference), so each
  matmul input differs by up to one bf16 rounding (2**-8 relative).
  SGD-momentum's update is linear in the gradients: within 2e-2 (five
  bf16 roundings; 5e-3 seen).  AdamW's step ``m / sqrt(v)`` is about
  ``lr`` whatever the gradient's size, so a near-zero gradient element
  whose bf16 sign differs between the packages moves by ``2 lr`` the
  other way: within 0.1 (0.046 seen).  Planted faults of the port's
  training -- no update, half the learning rate, no momentum (SGD), no
  weight decay (AdamW) -- are trained beside it and must each miss
  these limits (0.18-1.0 seen), so the limits are shown to be below
  the size of a wrong update.
- learning-rate schedules: rtol 1e-12 (the same Python float
  arithmetic).
- ``multi_precision`` (float16 weights, f32 master): masters within 1e-6
  relative and 1e-6 absolute (1e-4 of an update's size: one f32 update
  chain each, but the reference's eager Adam takes ``lr_t`` in double
  precision where the port takes it in float32), float16 weights within
  one float16 rounding (rtol 1e-3) of the reference's.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.llama import llama_tiny as jax_llama_tiny
from mxnet_tpu.optimizer import lr_scheduler as jsched

from mxnet_tpu_torch import amp, MXNetError, NotSupportedError
from mxnet_tpu_torch.convert import (llama_decode_weights_to_numpy,
                                     load_llama_decode_weights)
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama_tiny
from mxnet_tpu_torch.optimizer import create, lr_scheduler as sched

nd = mx.nd
flash_mod = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")
VOCAB, BATCH, SEQ = 256, 2, 16
# optimizer, its arguments, the update's limit, and planted faults
AMP_CASES = {
    "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2e-2,
            {"half lr": {"learning_rate": 0.05}, "no momentum":
             {"momentum": 0.0}}),
    "adamw": ("adamw", {"learning_rate": 5e-3, "wd": 0.1}, 0.1,
              {"half lr": {"learning_rate": 2.5e-3}, "no wd": {"wd": 0.0}})}
LOSS_ATOL = 2.0 ** -6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's torch work (restored
    after): the tier-1 run shares the host's cores among its workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _deinit_both():
    jamp._deinit_for_tests()
    amp._deinit_for_tests()


@pytest.fixture
def amp_bf16():
    jamp.init("bfloat16")
    amp.init("bfloat16")
    yield
    _deinit_both()


@pytest.fixture
def amp_fp16():
    jamp.init("float16")
    amp.init("float16")
    yield
    _deinit_both()


def _tree_to_numpy(tree):
    embed, norm, head, layers = tree
    return (np.asarray(embed, np.float32), np.asarray(norm, np.float32),
            None if head is None else np.asarray(head, np.float32),
            [tuple(np.asarray(w, np.float32) for w in layer)
             for layer in layers])


def _leaves(tree):
    embed, norm, head, layers = tree
    out = [embed, norm] + ([] if head is None else [head])
    for layer in layers:
        out.extend(layer)
    return out


def _batch():
    tokens = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ))
    labels = np.random.RandomState(1).randint(0, VOCAB, (BATCH * SEQ,))
    return tokens, labels


def _nets():
    """JAX ``llama_tiny(num_layers=1)`` initialised by the reference and
    the port's with the same weights."""
    jnet = jax_llama_tiny(num_layers=1)
    jnet.initialize()
    jnet(nd.array(_batch()[0]))
    pnet = load_llama_decode_weights(
        llama_tiny(num_layers=1, device="cpu", seed=None),
        _tree_to_numpy(jnet.decode_weights()))
    return jnet, pnet


# ----------------------------------------------------------------------
# bf16 AMP training: the slice as a whole
# ----------------------------------------------------------------------

def _train_port_amp(w0, optname, args, tokens, labels):
    """The port's ``llama_tiny`` from the weights ``w0`` trained 4 steps
    under ``amp.init_trainer`` and ``scale_loss``: (losses, weights,
    trainer)."""
    pnet = load_llama_decode_weights(
        llama_tiny(num_layers=1, device="cpu", seed=None), w0)
    ptr = Trainer(dict(pnet.named_parameters()), optname, dict(args))
    amp.init_trainer(ptr)
    losses = []
    for _ in range(4):
        logits = pnet(torch.from_numpy(tokens))
        ploss = SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                          torch.from_numpy(labels))
        with amp.scale_loss(ploss.mean(), ptr) as scaled:
            scaled.backward()
        ptr.step(BATCH)
        losses.append(float(ploss.detach().mean()))
    return losses, llama_decode_weights_to_numpy(pnet), ptr


def _update_errors(w0, w, ref):
    """Per leaf, ``|(w - w0) - (ref - w0)| / |ref - w0|``: how far an
    update is from the reference's, relative to the reference's size."""
    return [float(np.linalg.norm((b - a) - (c - a)) / np.linalg.norm(c - a))
            for a, b, c in zip(_leaves(w0), _leaves(w), _leaves(ref))]


@pytest.fixture(scope="module", params=sorted(AMP_CASES))
def amp_trained(request):
    """Both packages train ``llama_tiny`` 4 steps under
    ``amp.init("bfloat16")``, ``init_trainer`` and ``scale_loss``, and
    the port again with each planted fault (in a fixture: the JAX
    package's first AMP step compiles for seconds)."""
    optname, args, tol, faults = AMP_CASES[request.param]
    jamp.init("bfloat16")
    amp.init("bfloat16")
    try:
        jnet, _ = _nets()
        w0 = _tree_to_numpy(jnet.decode_weights())
        tokens, labels = _batch()
        jtr = jgluon.Trainer(jnet.collect_params(), optname, dict(args))
        jamp.init_trainer(jtr)
        jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
        jl, dtypes = [], []
        for _ in range(4):
            with autograd.record():
                out = jnet(nd.array(tokens))
                per = jloss_fn(out.reshape((-1, VOCAB)), nd.array(labels))
                loss = per.mean()
                with jamp.scale_loss(loss, jtr) as scaled:
                    scaled.backward()
            jtr.step(BATCH)
            jl.append(float(loss.asnumpy()))
            dtypes.append((str(out.dtype), str(per.dtype)))
        pl, pw, ptr = _train_port_amp(w0, optname, args, tokens, labels)
        planted = {name: _train_port_amp(w0, optname, dict(args, **change),
                                         tokens, labels)
                   for name, change in faults.items()}
    finally:
        _deinit_both()
    return dict(jax_losses=jl, port_losses=pl, tol=tol, trainer=ptr,
                jax_dtypes=dtypes, w0=w0, port_w=pw, planted=planted,
                jax_w=_tree_to_numpy(jnet.decode_weights()))


def test_amp_llama_training_matches_jax(amp_trained):
    got = amp_trained
    np.testing.assert_allclose(got["port_losses"], got["jax_losses"],
                               rtol=0, atol=LOSS_ATOL)
    assert got["port_losses"][-1] < got["port_losses"][0]
    assert got["trainer"]._bucket_apply is not None   # the flat update ran
    w0, ref, tol = got["w0"], got["jax_w"], got["tol"]
    errs = _update_errors(w0, got["port_w"], ref)
    assert max(errs) <= tol, errs
    # the limit is below a wrong update's distance: each planted fault,
    # and no update at all, misses it
    assert min(_update_errors(w0, w0, ref)) == 1.0
    for name, (_, w, _) in got["planted"].items():
        assert max(_update_errors(w0, w, ref)) > 1.5 * tol, name


def test_amp_dtypes_of_logits_loss_attention_and_gradients(
        amp_trained, monkeypatch):
    """Logits and loss leave in bf16 (as the reference's); flash
    attention's forward and backward take bf16 q, k, v and g; the
    parameters and their gradients stay f32."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = flash_mod.flash_attention_plain, \
        flash_mod.flash_attention_bwd_plain

    def record_fwd(q, k, v, *a, **kw):
        seen["fwd"].append((q.dtype, k.dtype, v.dtype))
        return fwd(q, k, v, *a, **kw)

    def record_bwd(q, k, v, out, lse, g, *a, **kw):
        seen["bwd"].append((q.dtype, k.dtype, v.dtype, out.dtype, g.dtype))
        return bwd(q, k, v, out, lse, g, *a, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_plain", record_fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_plain", record_bwd)
    pnet = llama_tiny(num_layers=1, device="cpu", seed=8)
    amp.init("bfloat16")
    tokens, labels = _batch()
    try:
        logits = pnet(torch.from_numpy(tokens))
        loss = SoftmaxCrossEntropyLoss()(logits.reshape(-1, VOCAB),
                                         torch.from_numpy(labels))
        loss.sum().backward()
    finally:
        amp._deinit_for_tests()
    bf16 = torch.bfloat16
    assert logits.dtype == bf16 and loss.dtype == bf16
    assert seen["fwd"] == [(bf16,) * 3] and seen["bwd"] == [(bf16,) * 5]
    for name, p in pnet.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name
    # the reference's, from its AMP training steps
    assert set(amp_trained["jax_dtypes"]) == {("bfloat16", "bfloat16")}


def test_without_amp_the_forward_is_unchanged_bitwise():
    """``amp.init`` then ``_deinit_for_tests`` leaves the f32 forward's
    bits as they were, and the policy is off."""
    net = llama_tiny(num_layers=1, device="cpu", seed=4)
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        before = net(tokens)
        amp.init("bfloat16")
        try:
            assert net(tokens).dtype == torch.bfloat16
        finally:
            amp._deinit_for_tests()
        after = net(tokens)
    assert after.dtype == torch.float32 and torch.equal(before, after)


# ----------------------------------------------------------------------
# loss scaling
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [False, False, True, False, False, False],
    [True, True, False, True] + [False] * 5,
    [False] * 7], ids=["grow-then-halve", "floor", "grow-twice"])
def test_loss_scaler_follows_the_reference(flags):
    """Growth every ``scale_window`` clean steps, halving on overflow
    (not below 1), a static scaler that never moves."""
    for kw in ({"init_scale": 4.0, "scale_window": 2},
               {"init_scale": 2.0, "scale_window": 3},
               {"init_scale": 1.0, "dynamic": False}):
        ref, port = jamp.LossScaler(**kw), amp.LossScaler(**kw)
        for f in flags:
            ref.update_scale(f)
            port.update_scale(f)
            assert port.loss_scale == ref.loss_scale


def test_loss_scaler_caps_the_scale():
    s = amp.LossScaler(init_scale=2.0 ** 23, scale_window=1)
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 2.0 ** 24


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan"),
                                 None])
def test_loss_scaler_has_overflow(bad):
    ps = [torch.nn.Parameter(torch.zeros(5, dtype=dt))
          for dt in (torch.float32, torch.float32, torch.float16)]
    ps[0].grad = torch.ones(5)
    ps[2].grad = torch.ones(5, dtype=torch.float16)
    if bad is not None:
        ps[2].grad[3] = bad
    assert amp.LossScaler().has_overflow(ps) == (bad is not None)


def _dense_pair():
    """A reference ``Dense(2)`` on 4 inputs and the port's parameter with
    the same weight."""
    net = jgluon.nn.Dense(2, use_bias=False)
    net.initialize()
    x = np.random.RandomState(5).uniform(size=(4, 4)).astype(np.float32)
    net(nd.array(x))
    w = torch.nn.Parameter(torch.from_numpy(
        np.array(net.weight.data().asnumpy())))
    return net, w, x


def test_fp16_overflow_skips_the_step_as_the_reference(amp_fp16):
    """Under ``amp.init("float16")`` an infinite gradient skips the step
    (weights unchanged, gradients dropped) and halves the scale; the
    next clean step updates, in both packages alike (the product in
    float16 in both, so the updated weights agree to float16's 1e-3)."""
    net, w, x = _dense_pair()
    w0 = w.detach().clone()
    jtr = jgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    ptr = Trainer({"weight": w}, "sgd", {"learning_rate": 0.1})
    jamp.init_trainer(jtr)
    amp.init_trainer(ptr)
    js, ps = jtr._amp_loss_scaler, ptr._amp_loss_scaler
    assert ps.loss_scale == js.loss_scale == 2.0 ** 16
    for scale, rtol in ((float("inf"), 0), (1e-3, 1e-3)):
        with autograd.record():
            loss = (net(nd.array(x)) * scale).sum()
            with jamp.scale_loss(loss, jtr) as scaled:
                scaled.backward()
        jtr.step(4)
        with amp.region("cpu"):
            ploss = (torch.from_numpy(x) @ w.T * scale).sum()
        with amp.scale_loss(ploss, ptr) as scaled:
            scaled.backward()
        ptr.step(4)
        assert ps.loss_scale == js.loss_scale
        assert w.grad is None
        np.testing.assert_allclose(w.detach().numpy(),
                                   net.weight.data().asnumpy(), rtol=rtol)
        if scale == float("inf"):
            assert torch.equal(w.detach(), w0)
    assert ps.loss_scale == 2.0 ** 15
    assert not torch.equal(w.detach(), w0)


def test_unscale_divides_the_gradients(amp_fp16):
    w = torch.nn.Parameter(torch.ones(3))
    tr = Trainer([w], "sgd")
    amp.init_trainer(tr)
    w.grad = torch.full((3,), 2.0 ** 17)
    amp.unscale(tr)
    assert torch.equal(w.grad, torch.full((3,), 2.0))


# ----------------------------------------------------------------------
# lists, conversion, refusals
# ----------------------------------------------------------------------

def test_lists_are_the_reference_lists():
    from mxnet_tpu.amp import lists as jlists
    from mxnet_tpu_torch.amp import lists
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS"):
        assert getattr(lists, name) == getattr(jlists, name), name
    assert amp.list_lp16_ops() == jamp.list_lp16_ops()
    assert amp.list_fp32_ops("float16") == jamp.list_fp32_ops("float16")


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_convert_hybrid_block_casts_the_parameters(target):
    net = llama_tiny(num_layers=1, device="cpu", seed=1)
    assert amp.convert_hybrid_block(net, target) is net
    want = getattr(torch, target)
    assert all(p.dtype == want for p in net.parameters())
    jnet = jgluon.nn.Dense(3)
    jnet.initialize()
    jnet(nd.zeros((2, 5)))
    jamp.convert_hybrid_block(jnet, target)
    assert str(jnet.weight.data().data.dtype) == target


def test_amp_refusals_and_order():
    tr = Trainer([torch.nn.Parameter(torch.ones(2))], "sgd")
    with pytest.raises(MXNetError, match="amp.init"):
        amp.init_trainer(tr)
    with pytest.raises(MXNetError):
        amp.init("int8")
    with pytest.raises(NotSupportedError, match="item 12"):
        amp.init(fp32_ops=["dot"])
    with pytest.raises(MXNetError, match="amp.init"):
        amp.init_trainer(tr)          # the refused init left it off
    with pytest.raises(NotSupportedError, match="symbol"):
        amp.convert_model(None, {}, {})
    with pytest.raises(MXNetError):
        amp.convert_hybrid_block(torch.nn.Linear(2, 2), "float64")


# ----------------------------------------------------------------------
# learning-rate schedules
# ----------------------------------------------------------------------

SCHEDULES = {
    "factor": ("FactorScheduler", dict(step=7, factor=0.5,
                                       stop_factor_lr=1e-3, base_lr=0.1)),
    "multifactor": ("MultiFactorScheduler", dict(step=[5, 12, 30],
                                                 factor=0.3, base_lr=0.1)),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                                   final_lr=1e-3)),
    "cosine": ("CosineScheduler", dict(max_update=40, base_lr=0.1,
                                       final_lr=1e-3))}


@pytest.mark.parametrize("warmup", [{}, {"warmup_steps": 6},
                                    {"warmup_steps": 6, "warmup_begin_lr":
                                     0.01, "warmup_mode": "constant"}],
                         ids=["no-warmup", "linear", "constant"])
@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedules_match_jax_over_50_updates(kind, warmup):
    name, kw = SCHEDULES[kind]
    ref = getattr(jsched, name)(**kw, **warmup)
    port = getattr(sched, name)(**kw, **warmup)
    for n in range(50):
        assert port(n) == pytest.approx(ref(n), rel=1e-12, abs=0), n


def test_schedules_refuse_what_the_reference_refuses():
    for make in (lambda m: m.FactorScheduler(step=0),
                 lambda m: m.FactorScheduler(step=2, factor=1.5),
                 lambda m: m.MultiFactorScheduler(step=[3, 3]),
                 lambda m: m.PolyScheduler(max_update=0),
                 lambda m: m.CosineScheduler(max_update=0),
                 lambda m: m.LRScheduler(warmup_mode="exp")):
        with pytest.raises(mx.MXNetError):
            make(jsched)
        with pytest.raises(MXNetError):
            make(sched)


SCHED_CASES = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 1e-6),
               "adam": ("adam", {"learning_rate": 5e-3}, 5e-5)}


@pytest.fixture(scope="module", params=sorted(SCHED_CASES))
def sched_trained(request):
    """A Trainer whose optimizer reads a warmup + factor schedule at its
    update count, and the reference's, 4 steps of ``llama_tiny`` in f32
    (in a fixture: the JAX package compiles for seconds at first)."""
    optname, args, atol = SCHED_CASES[request.param]
    jnet, pnet = _nets()
    tokens, labels = _batch()

    def schedule(m):
        return m.FactorScheduler(step=2, factor=0.5, warmup_steps=2,
                                 warmup_begin_lr=1e-3)

    jtr = jgluon.Trainer(jnet.collect_params(), optname,
                         dict(args, lr_scheduler=schedule(jsched)))
    ptr = Trainer(dict(pnet.named_parameters()), optname,
                  dict(args, lr_scheduler=schedule(sched)))
    lrs = []
    for _ in range(4):
        with autograd.record():
            loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
                jnet(nd.array(tokens)).reshape((-1, VOCAB)),
                nd.array(labels)).mean()
        loss.backward()
        jtr.step(BATCH)
        SoftmaxCrossEntropyLoss()(pnet(torch.from_numpy(tokens))
                                  .reshape(-1, VOCAB),
                                  torch.from_numpy(labels)).mean().backward()
        ptr.step(BATCH)
        lrs.append((ptr.learning_rate, jtr.learning_rate))
    return dict(lrs=lrs, trainer=ptr, atol=atol,
                jax_w=_tree_to_numpy(jnet.decode_weights()),
                port_w=llama_decode_weights_to_numpy(pnet))


def test_trainer_with_lr_scheduler_matches_jax(sched_trained):
    """Parameters within the f32 training tolerances of
    ``test_torch_port_training.py`` (1e-6 SGD, 5e-5 Adam), the schedule
    read at the same update counts, and ``set_learning_rate`` refused
    under a schedule, as in the reference."""
    got = sched_trained
    lrs = got["lrs"]
    assert [p for p, _ in lrs] == pytest.approx([j for _, j in lrs])
    assert lrs[0][0] != lrs[-1][0]
    with pytest.raises(MXNetError, match="lr_scheduler"):
        got["trainer"].set_learning_rate(0.5)
    for a, b in zip(_leaves(got["port_w"]), _leaves(got["jax_w"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=got["atol"])


# ----------------------------------------------------------------------
# multi_precision: float16 weights with an f32 master copy
# ----------------------------------------------------------------------

@pytest.mark.parametrize("optname,args", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adamw", {"learning_rate": 1e-2, "wd": 0.1})], ids=["sgd", "adamw"])
def test_multi_precision_float16_matches_jax(optname, args):
    rng = np.random.RandomState(6)
    w0 = rng.standard_normal((5, 7)).astype(np.float16)
    grads = [rng.standard_normal((5, 7)).astype(np.float16) for _ in range(3)]
    jopt = mx.optimizer.create(optname, multi_precision=True, **args)
    popt = create(optname, multi_precision=True, **args)
    jw = nd.array(w0, dtype="float16")
    pw = torch.from_numpy(w0.copy())
    jstate = jopt.create_state_multi_precision(0, jw)
    pstate = popt.create_state_multi_precision(0, pw)
    for g in grads:
        jopt.update_multi_precision(0, jw, nd.array(g, dtype="float16"),
                                    jstate)
        popt.update_multi_precision(0, pw, torch.from_numpy(g), pstate)
    assert pw.dtype == torch.float16 and pstate[1].dtype == torch.float32
    np.testing.assert_allclose(pstate[1].numpy(), jstate[1].asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pw.float().numpy(),
                               jw.asnumpy().astype(np.float32), rtol=1e-3)
    # the Trainer takes the same per-param path for a float16 parameter
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tr = Trainer({"w": tw}, optname, dict(args, multi_precision=True))
    for g in grads:
        tw.grad = torch.from_numpy(g)
        tr.step(1)
    assert tr._flat_param is None and tr._bucket_apply is None
    assert torch.equal(tw.detach(), pw)


def test_multi_precision_leaves_float32_weights_alone():
    """For float32 weights ``multi_precision`` keeps no master copy and
    the Trainer's flat update runs as without it, bitwise."""
    runs = []
    for mp in (False, True):
        ps = {k: torch.nn.Parameter(torch.linspace(-1, 1, 6) * i)
              for i, k in enumerate("ab", 1)}
        tr = Trainer(ps, "adam", {"learning_rate": 0.1,
                                  "multi_precision": mp})
        for _ in range(2):
            for p in ps.values():
                p.grad = torch.linspace(0.5, -0.5, 6)
            tr.step(2)
        assert tr._bucket_apply is not None
        runs.append([p.detach() for p in ps.values()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert create("sgd", multi_precision=True).create_state_multi_precision(
        0, torch.zeros(3)) == {}
