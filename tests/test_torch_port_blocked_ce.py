"""The port's blocked fused linear cross-entropy against the JAX
package's, on the CPU.

``mxnet_tpu_torch.ops.fused_linear_cross_entropy`` against
``mxnet_tpu.ops.fused_linear_cross_entropy`` (its ``custom_vjp``), the
``nd.contrib`` wrappers of both under ``autograd.record()``, and
``LlamaForCausalLM.fused_ce_loss`` of both (tied and untied heads, the
reference's weights carried across by structural name) and of the port
against its own logits path.  Inputs are numpy arrays from a seed.

Tolerances, with their reasons:

- float32: loss, dx and dw within 1e-5 (absolute and relative); both
  sides run the same online logsumexp block by block, and XLA and
  PyTorch sum the block products in other orders;
- a bf16 head weight: each block is widened to f32 exactly on both
  sides, so the loss and dx keep the f32 limit; dw is rounded to bf16 on
  both sides, so it is held to one bf16 ulp (2**-8 relative) of its
  magnitude, for the f32 sums that round either way;
- Llama's ``fused_ce_loss``: the per-token losses within 1e-5 of the
  reference's and of the port's own logits path
  (``SoftmaxCrossEntropyLoss``); one Adam step through
  ``Trainer(net.collect_params())`` on each loss gives parameters within
  5e-5, the limit ``test_torch_port_llama_block.py`` holds Adam training
  to (Adam's step is about ``lr`` wherever a gradient is tiny).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon, nd as jnd
from mxnet_tpu.gluon.model_zoo.nlp.llama import llama_tiny as jax_llama_tiny
from mxnet_tpu.ops import fused_linear_cross_entropy as jax_fused

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama_tiny
from mxnet_tpu_torch.ops import fused_linear_cross_entropy
from test_torch_port_amp import seeded

TOL = 1e-5
PARAM_ATOL = 5e-5
VOCAB, BATCH, SEQ = 256, 2, 16


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _case(seed, n, d, v, targets=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.1).astype(np.float32)
    t = rng.randint(0, v, (n,)) if targets is None else np.asarray(targets)
    return x, w, t.astype(np.int32)


def _jax(x, w, t, block, ignore_index=None):
    """The reference's loss and its gradients of ``sum(loss * g)``."""
    g = np.linspace(0.5, 1.5, len(t)).astype(np.float32)

    def f(a, b):
        loss = jax_fused(a, b, jnp.asarray(t), block, ignore_index)
        return jnp.sum(loss * g), loss
    (_, loss), (dx, dw) = jax.value_and_grad(f, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(loss), np.asarray(dx), np.asarray(dw), g


def _port(x, w, t, block, ignore_index=None, g=None, dtype=torch.float32):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w).to(dtype).requires_grad_(True)
    loss = fused_linear_cross_entropy(xt, wt, torch.from_numpy(t), block,
                                      ignore_index)
    (loss * torch.from_numpy(g)).sum().backward()
    return loss.detach(), xt.grad, wt.grad


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.float().numpy() if torch.is_tensor(got) else got, want,
        atol=tol, rtol=tol)


@pytest.mark.parametrize("n,d,v,block", [
    (12, 24, 500, 64), (12, 24, 500, 128), (12, 24, 500, 500),
    (12, 24, 500, 4096), (9, 16, 300, 100), (7, 8, 1, 64)])
def test_loss_and_gradients_match_the_reference(n, d, v, block):
    x, w, t = _case(n + v, n, d, v)
    loss, dx, dw, g = _jax(x, w, t, block)
    got = _port(x, w, t, block, g=g)
    assert got[0].dtype == torch.float32 and got[0].shape == (n,)
    for a, b in zip(got, (loss, dx, dw)):
        _close(a, b)


@pytest.mark.parametrize("ignore_index", [None, 7, -1])
def test_ignored_and_out_of_range_targets_give_zero(ignore_index):
    t = [5, -1, 99, 100, 7, -100, 250, 0]
    x, w, t = _case(4, len(t), 8, 100, t)
    loss, dx, dw, g = _jax(x, w, t, 32, ignore_index)
    lt, dxt, dwt = _port(x, w, t, 32, ignore_index, g)
    for a, b in zip((lt, dxt, dwt), (loss, dx, dw)):
        _close(a, b)
    dead = (t < 0) | (t >= 100)
    if ignore_index is not None:
        dead |= t == ignore_index
    assert dead.sum() >= 4
    assert (lt.numpy()[dead] == 0).all()
    assert (dxt.numpy()[dead] == 0).all()


def test_bf16_head_weight():
    x, w, t = _case(5, 16, 32, 700)
    wb = jnp.asarray(w, jnp.bfloat16)
    g = np.ones(16, np.float32)
    loss, (dx, dw) = jax.value_and_grad(
        lambda a, b: jnp.sum(jax_fused(a, b, jnp.asarray(t), 256)),
        (0, 1))(jnp.asarray(x), wb)
    ref_loss = np.asarray(jax_fused(jnp.asarray(x), wb, jnp.asarray(t), 256))
    lt, dxt, dwt = _port(x, np.asarray(wb.astype(jnp.float32)), t, 256,
                         g=g, dtype=torch.bfloat16)
    assert dwt.dtype == torch.bfloat16
    _close(lt, ref_loss)
    _close(dxt, np.asarray(dx))
    dw32 = np.asarray(dw.astype(jnp.float32))
    np.testing.assert_allclose(dwt.float().numpy(), dw32, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(dw32).max())


def test_dw_takes_the_weight_layout():
    """A transposed (V, d) parameter gets a gradient laid out as the
    parameter: each block of dW is whole rows of it."""
    x, w, t = _case(6, 5, 8, 40)
    base = torch.tensor(w.T.copy(), requires_grad=True)        # (V, d)
    fused = fused_linear_cross_entropy(torch.from_numpy(x), base.T,
                                       torch.from_numpy(t), 16)
    fused.sum().backward()
    assert base.grad.is_contiguous()
    logits = torch.from_numpy(x) @ base.detach().T
    want = torch.func.grad(lambda b: torch.nn.functional.cross_entropy(
        torch.from_numpy(x) @ b.T, torch.from_numpy(t).long(),
        reduction="sum"))(base.detach())
    _close(base.grad, want.numpy())
    _close(fused.detach(), torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(t).long(), reduction="none").numpy())


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else [out]:
            if torch.is_tensor(o):
                self.numels.append(o.numel())
        return out


def test_the_full_logits_never_exist():
    """No tensor of N x V elements (or more, but for the (d, V) weight
    gradient) is made in the forward or the backward."""
    n, d, v = 6, 4, 5000
    x, w, t = _case(7, n, d, v)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    with _Shapes() as rec:
        fused_linear_cross_entropy(xt, wt, torch.from_numpy(t), 512).sum() \
            .backward()
    big = [k for k in rec.numels if k >= n * v and k != d * v]
    assert not big, big
    assert max(rec.numels) == d * v


def test_nd_contrib_under_autograd_matches_the_reference():
    x, w, t = _case(3, 6, 12, 200)
    tf = t.astype(np.float32)              # the reference's test feeds floats
    jx, jw = jnd.array(x), jnd.array(w)
    jx.attach_grad()
    jw.attach_grad()
    with jautograd.record():
        jloss = jnd.contrib.fused_linear_cross_entropy(jx, jw, jnd.array(tf),
                                                       block=64)
        jloss.mean().backward()
    px, pw = nd.array(x, ctx=mx.cpu()), nd.array(w, ctx=mx.cpu())
    px.attach_grad()
    pw.attach_grad()
    with autograd.record():
        ploss = nd.contrib.fused_linear_cross_entropy(
            px, pw, nd.array(tf, ctx=mx.cpu()), block=64)
        ploss.mean().backward()
    assert isinstance(ploss, nd.NDArray) and ploss.shape == (6,)
    _close(ploss.asnumpy(), jloss.asnumpy())
    _close(px.grad.asnumpy(), jx.grad.asnumpy())
    _close(pw.grad.asnumpy(), jw.grad.asnumpy())
    # a plain array of targets is taken too
    _close(nd.contrib.fused_linear_cross_entropy(px, pw, t, block=64)
           .asnumpy(), jloss.asnumpy())


# ----------------------------------------------------------------------
# LlamaForCausalLM.fused_ce_loss
# ----------------------------------------------------------------------

def _tokens(seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module", params=[False, True], ids=["head", "tied"])
def llama(request):
    """The reference's net, its weights, its fused losses and its
    parameters after one Adam step on their mean."""
    tie = request.param
    jnet = jax_llama_tiny(tie_embeddings=tie)
    toks, targets = _tokens(1), _tokens(2)
    targets[0, :3] = -100                   # ignored
    with seeded(0):
        jnet.initialize()
        jnet(jmx.nd.array(toks, dtype="int32"))
    w0 = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    jt, jy = jmx.nd.array(toks, dtype="int32"), jmx.nd.array(targets)
    loss = jnet.fused_ce_loss(jt, jy, block=64, ignore_index=-100).asnumpy()
    tr = jgluon.Trainer(jnet.collect_params(), "adam",
                        {"learning_rate": 1e-3})
    with jautograd.record():
        total = jnet.fused_ce_loss(jt, jy, block=64, ignore_index=-100) \
            .mean()
    total.backward()
    tr.step(1)
    w1 = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    return dict(tie=tie, toks=toks, targets=targets, w0=w0, loss=loss,
                w1=w1)


def _port_llama(llama):
    return load_block_weights(
        llama_tiny(tie_embeddings=llama["tie"], device="cpu"), llama["w0"])


def _nd(a):
    return nd.array(a, ctx=mx.cpu())


def test_llama_fused_ce_loss_matches_the_reference(llama):
    net = _port_llama(llama)
    loss = net.fused_ce_loss(_nd(llama["toks"]), _nd(llama["targets"]),
                             block=64, ignore_index=-100)
    assert isinstance(loss, nd.NDArray) and loss.shape == (BATCH, SEQ)
    _close(loss.asnumpy(), llama["loss"])
    assert (loss.asnumpy()[0, :3] == 0).all()


def test_llama_fused_ce_loss_matches_the_logits_path(llama):
    net = _port_llama(llama)
    toks, targets = _tokens(3), _tokens(4)
    fused = net.fused_ce_loss(_nd(toks), _nd(targets), block=100)
    logits = net(_nd(toks))
    plain = SoftmaxCrossEntropyLoss(axis=-1, batch_axis=0)(
        logits.reshape((-1, VOCAB)), _nd(targets).reshape((-1,)))
    _close(fused.asnumpy().reshape(-1), plain.asnumpy())


def test_llama_fused_ce_loss_trains_as_the_reference(llama):
    """One Adam step through ``Trainer(net.collect_params())`` on the
    fused loss's mean gives the reference's parameters."""
    net = _port_llama(llama)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    with autograd.record():
        total = net.fused_ce_loss(_nd(llama["toks"]), _nd(llama["targets"]),
                                  block=64, ignore_index=-100).mean()
    total.backward()
    tr.step(1)
    for k, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(), llama["w1"][k],
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_llama_fused_and_logits_paths_train_alike(llama):
    """Two Adam steps on each path from the same weights: the losses
    within 1e-5, the parameters within the Adam limit."""
    runs = []
    toks, targets = _tokens(5), _tokens(6)
    for fused in (True, False):
        net = _port_llama(llama)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-3})
        losses = []
        for _ in range(2):
            with autograd.record():
                if fused:
                    loss = net.fused_ce_loss(_nd(toks), _nd(targets),
                                             block=64).mean()
                else:
                    loss = SoftmaxCrossEntropyLoss()(
                        net(_nd(toks)), _nd(targets)).mean()
            loss.backward()
            tr.step(1)
            losses.append(float(loss.asnumpy()))
        runs.append((losses, {k: p.data().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()}))
    _close(np.array(runs[0][0]), np.array(runs[1][0]))
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(v, runs[1][1][k], atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
