"""The port's ``LlamaForCausalLM.generate`` against the JAX package's, on
the CPU.

Both packages build ``llama_tiny`` (2 layers, hidden 64, 4/2 heads,
vocab 256), tied and untied; the reference initializes it and its
parameters cross into the port by structural name
(``convert.load_block_weights``).  Prefixes are numpy token batches from
a seed.  The reference's ``generate`` compiles once a signature, so its
calls run in module fixtures and each test stays under the duration
guard.

What is held, with its reason:

- greedy tokens identical to the reference's (float32; an argmax over
  logits that agree to about 1e-6), to the port's own greedy loop of
  full forwards (the reference's own check), and to the port's serving
  engine's greedy streams (paged pool, the same math in float32);
- sampling: the same seed gives the same tokens, another seed other
  tokens; each draw is ``torch.multinomial(p, 1)``'s, from the same
  numbers of the generator (the port's exponential race, which a CUDA
  graph can capture), and a single position's draws follow ``p`` (a
  frequency test); JAX's keys draw other bits, so sampled streams are
  not compared across the packages (ROADMAP §3);
- a weight change is seen: in place (the cached step is reused) and in
  new storage (the step is made again, keyed on the weights' addresses);
- ``T_prefix == 0`` raises ``MXNetError``, as the reference's does.
"""
import jax  # noqa: F401  (the reference runs on the CPU)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.nlp.llama import llama_tiny as jax_llama_tiny

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (_categorical,
                                                       llama_tiny)

VOCAB, BATCH, PREFIX, NEW = 256, 2, 5, 10


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _prefix(seed=0, batch=BATCH, n=PREFIX):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (batch, n)).astype(np.int32)


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jax_net(tie, seed):
    jmx.random.seed(seed)
    net = jax_llama_tiny(tie_embeddings=tie)
    net.initialize()
    net(jmx.nd.array(_prefix(), dtype="int32"))
    return net


@pytest.fixture(scope="module", params=[False, True], ids=["head", "tied"])
def ref(request):
    """Two reference nets' weights and their greedy ``generate`` tokens
    on two prefixes."""
    tie = request.param
    out = {"tie": tie, "weights": [], "tokens": []}
    for seed in (0, 1):
        jnet = _jax_net(tie, seed)
        out["weights"].append(_weights(jnet))
        out["tokens"].append([
            jnet.generate(jmx.nd.array(_prefix(s), dtype="int32"),
                          NEW).asnumpy() for s in (0, 1)])
    return out


def _port(weights, tie):
    return load_block_weights(llama_tiny(tie_embeddings=tie, device="cpu"),
                              weights)


def _nd(a):
    return mx.nd.array(a, ctx=mx.cpu(), dtype="int32")


def _greedy_loop(net, prefix, n):
    """The reference's check: a full forward of the whole sequence each
    step, the last position's argmax appended."""
    cur = np.asarray(prefix)
    for _ in range(n):
        logits = net(_nd(cur)).asnumpy()
        cur = np.concatenate(
            [cur, logits[:, -1].argmax(-1).astype(np.int32)[:, None]], 1)
    return cur


def test_greedy_tokens_equal_the_reference(ref):
    net = _port(ref["weights"][0], ref["tie"])
    for s, want in zip((0, 1), ref["tokens"][0]):
        out = net.generate(_nd(_prefix(s)), NEW)
        assert isinstance(out, mx.nd.NDArray)
        assert out.dtype == np.int32 and out.shape == (BATCH, PREFIX + NEW)
        np.testing.assert_array_equal(out.asnumpy(), want)
        np.testing.assert_array_equal(out.asnumpy()[:, :PREFIX], _prefix(s))


def test_greedy_tokens_equal_the_full_forward_loop(ref):
    net = _port(ref["weights"][1], ref["tie"])
    np.testing.assert_array_equal(net.generate(_prefix(1), NEW).asnumpy(),
                                  _greedy_loop(net, _prefix(1), NEW))


def test_weight_changes_are_seen(ref):
    """New values in the same storage reuse the cached step and decode
    the new weights; weights in new storage make the step again."""
    tie = ref["tie"]
    net = _port(ref["weights"][0], tie)
    prefix = _nd(_prefix(0))
    np.testing.assert_array_equal(net.generate(prefix, NEW).asnumpy(),
                                  ref["tokens"][0][0])
    steps = net._generate_cache["steps"]
    step = next(iter(steps.values()))
    load_block_weights(net, ref["weights"][1])            # in place
    np.testing.assert_array_equal(net.generate(prefix, NEW).asnumpy(),
                                  ref["tokens"][1][0])
    assert next(iter(steps.values())) is step
    for name, p in net._collect_params_with_prefix().items():
        p._bind(torch.from_numpy(ref["weights"][0][name].copy()))
    np.testing.assert_array_equal(net.generate(prefix, NEW).asnumpy(),
                                  ref["tokens"][0][0])
    assert len(steps) == 1 and next(iter(steps.values())) is not step


def test_generate_after_trainer_steps_decodes_the_trained_weights(ref):
    """A Trainer moves the parameters into its flat buffer at its first
    step and updates them in place after: generate follows both."""
    net = _port(ref["weights"][0], ref["tie"])
    prefix = _prefix(1)
    before = net.generate(prefix, NEW).asnumpy()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 5e-2})
    toks, labels = _prefix(2, n=8), _prefix(3, n=8)
    for _ in range(2):
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(_nd(toks)), _nd(labels))
        loss.backward()
        trainer.step(BATCH)
        out = net.generate(prefix, NEW).asnumpy()
        np.testing.assert_array_equal(out,
                                      _greedy_loop(net, prefix, NEW))
    assert not np.array_equal(out, before)


def test_sampling_is_reproducible_and_moved_by_the_seed(ref):
    net = _port(ref["weights"][0], ref["tie"])
    prefix = _prefix(0)
    a = net.generate(prefix, NEW, temperature=1.0, seed=0).asnumpy()
    b = net.generate(prefix, NEW, temperature=1.0, seed=0).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (BATCH, PREFIX + NEW)
    assert ((a >= 0) & (a < VOCAB)).all()
    assert any(not np.array_equal(
        a, net.generate(prefix, NEW, temperature=1.0, seed=s).asnumpy())
        for s in (1, 2, 3))


def test_sampling_draws_as_multinomial(ref):
    """Each step draws as ``torch.multinomial(softmax(logits / T), 1)``
    with the generator seeded by ``seed`` at the call; every position
    draws, the prefix's included (their draws are discarded).  The
    logits of the reference loop come from full forwards."""
    net = _port(ref["weights"][1], ref["tie"])
    prefix, temp, seed = _prefix(1), 0.7, 5
    got = net.generate(prefix, NEW, temperature=temp, seed=seed).asnumpy()
    gen = torch.Generator().manual_seed(seed)
    cur = prefix
    for i in range(PREFIX + NEW):
        logits = net(_nd(cur[:, :i + 1] if i < PREFIX else cur)).data
        p = torch.softmax(logits[:, -1].float() / temp, dim=-1)
        pick = torch.multinomial(p, 1, generator=gen)[:, 0]
        if PREFIX - 1 <= i < PREFIX + NEW - 1:
            cur = np.concatenate([cur, pick.numpy().astype(np.int32)[:, None]],
                                 1)
    np.testing.assert_array_equal(got, cur)


def test_categorical_frequencies_follow_p():
    """Over 40000 rows of one distribution the draws' frequencies are
    within 5 standard errors of ``p``."""
    n = 40000
    p = torch.tensor([0.5, 0.25, 0.15, 0.07, 0.03])
    gen = torch.Generator().manual_seed(11)
    picks = _categorical(torch.log(p).expand(n, -1), gen)
    freq = torch.bincount(picks, minlength=5).double() / n
    se = torch.sqrt(p.double() * (1 - p.double()) / n)
    assert torch.all((freq - p.double()).abs() <= 5 * se), (freq, p)


def test_empty_prefix_raises_and_other_shapes_too():
    net = llama_tiny(device="cpu", seed=0)
    with pytest.raises(MXNetError):
        net.generate(np.zeros((2, 0), np.int32), 4)
    with pytest.raises(MXNetError):
        net.generate(np.zeros(3, np.int32), 4)


def test_one_step_a_signature_and_no_graph_on_the_cpu():
    net = llama_tiny(device="cpu", seed=0)
    for n in (4, 4, 6):
        net.generate(_prefix(0), n)
    net.generate(_prefix(0), 4, temperature=0.5)
    assert sorted(net._generate_cache["steps"]) == [
        (BATCH, PREFIX, PREFIX + 4, 0.0), (BATCH, PREFIX, PREFIX + 4, 0.5),
        (BATCH, PREFIX, PREFIX + 6, 0.0)]
    assert net.generate_stats() == {"captures": 0, "capture_seconds": 0.0,
                                    "graphs": 0}


def test_greedy_tokens_equal_the_serving_engine_s(ref):
    """In float32 ``generate``'s dense caches and the engine's paged
    pool decode the same greedy streams (prefill, then one decode step a
    token)."""
    from mxnet_tpu_torch.serving import InferenceEngine
    net = _port(ref["weights"][0], ref["tie"])
    eng = InferenceEngine(net, max_batch=2, block_size=16, max_context=64,
                          device="cpu")
    prompts = _prefix(4, n=12)
    gen = net.generate(prompts, NEW).asnumpy()
    for i, p in enumerate(prompts):
        tok, _ = eng.prefill(i, p.tolist())
        fed = p.tolist() + [tok]
        while len(fed) < 12 + NEW:
            assert eng.reserve(i, len(fed) - 1)
            nxt, _ = eng.decode([(i, fed[-1], len(fed) - 1)])
            fed.append(int(nxt[0]))
        np.testing.assert_array_equal(gen[i], fed)
