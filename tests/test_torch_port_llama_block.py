"""The port's Llama as Gluon ``HybridBlock``s against the JAX package's,
on the CPU.

Both packages build ``llama_tiny`` (2 layers, hidden 64, 4/2 heads,
vocab 256); the reference initializes it, and its parameters cross into
the port by structural name (``convert.load_block_weights``) or through
a ``save_parameters`` file, never drawn twice.  Inputs are numpy token
batches from a seed.  The reference's training runs in module fixtures,
so each test's call stays under the duration guard.

Tolerances, with their reasons:

- logits within 1e-5 (float32; XLA and PyTorch sum in other orders and
  lower RoPE's pow/cos/sin differently);
- 3 AdamW steps through ``Trainer(net.collect_params())`` and 3 Adam
  steps through ``DataParallelTrainer`` at dp=1: losses within 1e-5
  relative, parameters within 5e-5 absolute, the limits
  ``test_torch_port_training.py`` holds Llama's Adam training to
  (Adam's ``m / sqrt(v)`` step is about ``lr`` wherever ``|g|`` is
  small, so a last-digit difference in a tiny gradient moves a parameter
  by a fraction of ``lr``);
- a ``save_parameters`` file crosses bitwise, ``remat()`` gives the
  gradients of the plain forward bitwise (the same ops recomputed), and
  the seeded construction equals the explicit draw bitwise.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.llama import llama_tiny as jax_llama_tiny
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.data_parallel import DataParallelTrainer as JTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel
from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                     llama_decode_weights_to_numpy,
                                     load_block_weights,
                                     load_llama_decode_weights)
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo.nlp import llama as port_llama
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM,
                                                       llama_tiny)

VOCAB, BATCH, SEQ = 256, 2, 16
LOGIT_ATOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
ADAMW = {"learning_rate": 5e-3, "wd": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
            rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32))


def _jax_net(tie):
    jmx.random.seed(0)
    net = jax_llama_tiny(tie_embeddings=tie)
    net.initialize()
    net(jmx.nd.array(_batch()[0], dtype="int32"))
    return net


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _port_net(weights, tie):
    net = llama_tiny(tie_embeddings=tie, device="cpu")
    return load_block_weights(net, weights)


def _nd(a):
    return mx.nd.array(a, ctx=mx.cpu())


@pytest.fixture(scope="module", params=[False, True], ids=["head", "tied"])
def nets(request):
    jnet = _jax_net(request.param)
    return request.param, jnet, _port_net(_weights(jnet), request.param)


# ----------------------------------------------------------------------
# structure, forward and parameter files
# ----------------------------------------------------------------------

def test_blocks_and_structural_names_equal_the_reference(nets):
    tie, jnet, pnet = nets
    for cls in (port_llama.RMSNorm, port_llama.LlamaAttention,
                port_llama.LlamaMLP, port_llama.LlamaLayer,
                port_llama.LlamaModel, LlamaForCausalLM):
        assert issubclass(cls, HybridBlock), cls
    want = {k: p.shape for k, p in jnet._collect_params_with_prefix().items()}
    got = {k: tuple(p.data().shape)
           for k, p in pnet._collect_params_with_prefix().items()}
    assert list(got) == list(want)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert ("lm_head.weight" in got) == (not tie)
    assert len(pnet.collect_params()) == len(jnet.collect_params())


def test_logits_match_the_reference(nets):
    _, jnet, pnet = nets
    toks = _batch(1)[0]
    ref = jnet(jmx.nd.array(toks, dtype="int32")).asnumpy()
    out = pnet(_nd(toks))
    assert isinstance(out, mx.nd.NDArray)
    assert out.shape == ref.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(out.asnumpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_decode_weights_are_the_parameters_and_convert_still_works(nets):
    tie, jnet, pnet = nets
    embed, norm, head, layers = pnet.decode_weights()
    assert embed is pnet.model.embed.weight.data().data
    assert (head is None) == tie
    assert layers[1][1] is \
        pnet.model.layers[1].attention.q_proj.weight.data().data
    tree = llama_decode_weights_to_numpy(pnet)
    ref = jnet.decode_weights()
    np.testing.assert_array_equal(tree[3][0][8], np.asarray(ref[3][0][8]))
    other = llama_tiny(tie_embeddings=tie, device="cpu")
    load_llama_decode_weights(other, tree)
    for k, v in block_weights_to_numpy(other).items():
        np.testing.assert_array_equal(v, _weights(jnet)[k], err_msg=k)


def test_save_parameters_crosses_both_ways(nets, tmp_path):
    tie, jnet, pnet = nets
    jfile, pfile = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jnet.save_parameters(jfile)
    from_jax = llama_tiny(tie_embeddings=tie)          # deferred
    from_jax.load_parameters(jfile, ctx=mx.cpu())
    for k, v in block_weights_to_numpy(from_jax).items():
        np.testing.assert_array_equal(v, _weights(jnet)[k], err_msg=k)
    pnet.save_parameters(pfile)
    back = _jax_net(tie)
    back.collect_params().initialize(force_reinit=True,
                                     init=jmx.init.Zero())
    back.load_parameters(pfile)
    for k, v in _weights(back).items():
        np.testing.assert_array_equal(v, _weights(pnet)[k], err_msg=k)


def test_reference_construction_defers_to_initialize():
    """``LlamaForCausalLM(cfg)`` holds no data until
    ``initialize(ctx=...)``, as the reference's; the norms start at 1."""
    net = LlamaForCausalLM(LlamaConfig(vocab_size=VOCAB, hidden_size=64,
                                       intermediate_size=128, num_layers=1,
                                       num_heads=4, num_kv_heads=2))
    with pytest.raises(mx.MXNetError, match="initialize"):
        net(_nd(_batch()[0]))
    net.initialize(ctx=mx.cpu())
    assert torch.equal(net.model.norm.weight.data().data, torch.ones(64))
    assert net(_nd(_batch()[0])).shape == (BATCH, SEQ, VOCAB)


def test_placed_net_holds_no_data_until_loaded():
    """With a device and no seed the parameters are placed there and hold
    no data: a forward and an ``InferenceEngine`` raise until ``convert``
    writes them, on that device."""
    from mxnet_tpu_torch.serving import InferenceEngine
    weights = block_weights_to_numpy(llama_tiny(device="cpu", seed=0))
    net = llama_tiny(device="cpu")
    with pytest.raises(mx.MXNetError, match="initialize"):
        net(_nd(_batch()[0]))
    with pytest.raises(mx.MXNetError, match="initialize"):
        InferenceEngine(net, device="cpu")
    load_block_weights(net, weights)
    for k, v in block_weights_to_numpy(net).items():
        np.testing.assert_array_equal(v, weights[k], err_msg=k)
    assert net.model.embed.weight.data().data.device.type == "cpu"
    assert net(_nd(_batch()[0])).shape == (BATCH, SEQ, VOCAB)


def test_seeded_draw_is_the_explicit_order_draw():
    """``seed`` draws every weight from one generator in the order of
    the structural names (embed; per layer in_norm, q, k, v, o,
    post_norm, gate, up, down; the final norm; lm_head): norms 1, the
    rest normal with std 0.02, bitwise.  bf16 parameters follow
    ``dtype``."""
    for tie in (False, True):
        net = llama_tiny(tie_embeddings=tie, device="cpu", seed=5)
        cfg = net.cfg
        gen = torch.Generator().manual_seed(5)
        d, f, kv = cfg.hidden_size, cfg.intermediate_size, \
            cfg.num_kv_heads * cfg.head_dim
        want = [("model.embed.weight", (cfg.vocab_size, d))]
        for i in range(cfg.num_layers):
            p = f"model.layers.{i}."
            want += [(p + "input_norm.weight", (d,)),
                     (p + "attention.q_proj.weight", (d, d)),
                     (p + "attention.k_proj.weight", (kv, d)),
                     (p + "attention.v_proj.weight", (kv, d)),
                     (p + "attention.o_proj.weight", (d, d)),
                     (p + "post_norm.weight", (d,)),
                     (p + "mlp.gate_proj.weight", (f, d)),
                     (p + "mlp.up_proj.weight", (f, d)),
                     (p + "mlp.down_proj.weight", (d, f))]
        want.append(("model.norm.weight", (d,)))
        if not tie:
            want.append(("lm_head.weight", (cfg.vocab_size, d)))
        got = net._collect_params_with_prefix()
        assert list(got) == [name for name, _ in want]
        for name, shape in want:
            w = torch.empty(shape)
            if name.endswith("norm.weight"):
                w.fill_(1.0)
            else:
                w.normal_(0.0, 0.02, generator=gen)
            assert torch.equal(got[name].data().data, w), name
    bf16 = llama_tiny(device="cpu", dtype=torch.bfloat16, seed=5)
    assert {p.data().data.dtype for p in bf16.collect_params().values()} \
        == {torch.bfloat16}


# ----------------------------------------------------------------------
# training through the Gluon surface
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The reference trained 3 AdamW steps through
    ``gluon.Trainer(net.collect_params())``, and the port from the same
    weights."""
    jnet = _jax_net(False)
    w0 = _weights(jnet)
    pnet = _port_net(w0, False)
    jtr = jgluon.Trainer(jnet.collect_params(), "adamw", dict(ADAMW))
    ptr = gluon.Trainer(pnet.collect_params(), "adamw", dict(ADAMW))
    jce, pce = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        gluon.loss.SoftmaxCrossEntropyLoss()
    jl, pl = [], []
    for step in range(3):
        toks, labels = _batch(step)
        with jautograd.record():
            jloss = jce(jnet(jmx.nd.array(toks, dtype="int32")),
                        jmx.nd.array(labels, dtype="int32")).mean()
        jloss.backward()
        jtr.step(BATCH)
        with mx.autograd.record():
            ploss = pce(pnet(_nd(toks)), _nd(labels)).mean()
        ploss.backward()
        ptr.step(BATCH)
        jl.append(float(jloss.asnumpy()))
        pl.append(float(ploss.asnumpy()))
    return dict(jl=jl, pl=pl, jw=_weights(jnet), pw=_weights(pnet),
                trainer=ptr)


def test_trainer_over_collect_params_matches_the_reference(trained):
    np.testing.assert_allclose(trained["pl"], trained["jl"], rtol=LOSS_RTOL)
    assert trained["pl"][-1] < trained["pl"][0]
    for k, want in trained["jw"].items():
        np.testing.assert_allclose(trained["pw"][k], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    # every parameter joined the flat buffer and took the one bucket update
    tr = trained["trainer"]
    assert tr._flat_param is not None and tr._bucket_apply is not None
    assert set(tr._optimizer._index_update_count.values()) == {3}


def _dp_loss(pkg):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        return ce(out, label)
    return loss_fn


@pytest.fixture(scope="module")
def dp_trained():
    """3 Adam steps of ``llama_tiny`` through both packages'
    ``DataParallelTrainer`` on a one-device mesh."""
    jnet = _jax_net(False)
    w0 = _weights(jnet)
    jtr = JTrainer(jnet, _dp_loss(jmx), "adam", {"learning_rate": 5e-3},
                   mesh=jmake_mesh({"dp": 1}, devices=jax.devices()[:1]))
    pnet = _port_net(w0, False)
    with mx.cpu():
        mesh = parallel.make_mesh({"dp": 1})
    ptr = parallel.DataParallelTrainer(pnet, _dp_loss(mx), "adam",
                                       {"learning_rate": 5e-3}, mesh=mesh)
    jl, pl = [], []
    for step in range(3):
        toks, labels = _batch(step)
        jl.append(float(np.asarray(jtr.step(toks, labels).asnumpy())))
        pl.append(float(np.asarray(ptr.step(toks, labels).asnumpy())))
    return dict(jl=jl, pl=pl, jw=_weights(jnet), pw=_weights(pnet))


def test_data_parallel_trainer_matches_the_reference(dp_trained):
    np.testing.assert_allclose(dp_trained["pl"], dp_trained["jl"],
                               rtol=LOSS_RTOL)
    assert dp_trained["pl"][-1] < dp_trained["pl"][0]
    for k, want in dp_trained["jw"].items():
        np.testing.assert_allclose(dp_trained["pw"][k], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _grads(net, toks, labels):
    with mx.autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(_nd(toks)), _nd(labels)).mean()
    loss.backward()
    return {k: p.grad().data.clone()
            for k, p in net._collect_params_with_prefix().items()}


def test_remat_gives_the_same_gradients():
    """``model.remat()`` recomputes each layer in the backward: the
    gradients are the plain forward's, bitwise."""
    weights = _weights(_jax_net(False))
    toks, labels = _batch(3)
    plain = _grads(_port_net(weights, False), toks, labels)
    net = _port_net(weights, False)
    net.model.remat()
    assert all(layer._flags["remat"] for layer in net.model.layers)
    remat = _grads(net, toks, labels)
    for k, g in plain.items():
        assert torch.equal(remat[k], g), k
