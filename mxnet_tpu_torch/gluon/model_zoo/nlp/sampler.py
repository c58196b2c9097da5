"""Sequence samplers: beam search and sequence sampling.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/sampler.py`` (GluonNLP's
``BeamSearchSampler`` and ``SequenceSampler``).  The beam bookkeeping
(top-k over vocab x beam, back-pointers, lengths) runs on the device of
the inputs, so only the final sequences need the host; the all-done
early exit is read on the host once every ``sync_every`` steps.

Token selection goes through one :func:`_topk`, which orders ties by
the lower index as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among ties): beams over tied log-probs pick the reference's
tokens.

``step_mode``: ``"ndarray"`` hands the decoder its step input as an
NDArray (a Gluon decoder); ``"jax"`` hands it the raw tensor, which in
the port is a ``torch.Tensor`` (ROADMAP §3); ``"auto"`` takes raw
tensors for a callable flagged ``expects_ndarray = False`` and NDArrays
otherwise.  ``SequenceSampler`` draws from the device's ``nd.random``
generator (``ndarray.random.generator``), where the reference splits
``mx.random``'s key: snapshot and restore that generator's state
(``get_state``/``set_state``) to replay a sample.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....ndarray import random as _rnd
from ....ndarray.ndarray import NDArray
from .llama import _categorical

__all__ = ["BeamSearchScorer", "BeamSearchSampler", "SequenceSampler"]


class BeamSearchScorer:
    """Length-penalized log-prob scorer (Google NMT alpha/K rule).
    Reference: gluonnlp BeamSearchScorer."""

    def __init__(self, alpha=1.0, K=5.0):
        self._alpha = alpha
        self._K = K

    def _lp(self, step):
        return ((self._K + step) ** self._alpha) / \
            ((self._K + 1) ** self._alpha)

    def __call__(self, log_probs, scores, step):
        """GNMT rule: total log-prob / lp(length).  ``scores`` holds the
        previous step's normalized totals, so they are un-normalized by
        lp(step - 1) before this step's log-probs are added."""
        prev = self._lp(step - 1) if step > 1 else 1.0
        return (scores[:, None] * prev + log_probs) / self._lp(step)


def _is_raw_step(decoder):
    """A callable flagged ``expects_ndarray = False`` takes and returns
    raw tensors; anything else takes NDArrays."""
    flag = getattr(decoder, "expects_ndarray", None)
    return flag is not None and not flag


class _StepCaller:
    """The decoder's calling convention, fixed at construction: NDArray
    step inputs (Gluon blocks) or raw tensors; the log-probs come back
    as a tensor either way."""

    def __init__(self, decoder, step_mode="auto"):
        if step_mode not in ("auto", "ndarray", "jax"):
            raise MXNetError(f"step_mode={step_mode!r}: expected "
                             "auto|ndarray|jax")
        self._decoder = decoder
        self._raw = (_is_raw_step(decoder) if step_mode == "auto"
                     else step_mode == "jax")

    def __call__(self, step_input, states):
        si = step_input if self._raw else NDArray(step_input)
        log_probs, states = self._decoder(si, states)
        lp = log_probs.data if isinstance(log_probs, NDArray) else \
            torch.as_tensor(log_probs)
        return lp, states


def _tensor(x):
    return x.data if isinstance(x, NDArray) else torch.as_tensor(x)


def _ids_dtype(ids):
    """The samples' dtype: the first ids' dtype promoted with int32, as
    the reference stacks them with its int32 picks."""
    return torch.promote_types(ids.dtype, torch.int32)


class BeamSearchSampler:
    """Beam search over a step decoder.

    ``decoder(step_input, states) -> (log_probs, states)``: step_input
    is (batch*beam,) ids and log_probs (batch*beam, vocab); states is a
    tree (lists, tuples, dicts) of NDArrays or tensors with a leading
    batch*beam axis.  ``step_mode`` and ``sync_every``: see the module
    doc."""

    def __init__(self, beam_size, decoder, eos_id, scorer=None,
                 max_length=100, step_mode="auto", sync_every=8):
        self._beam_size = beam_size
        self._decoder = _StepCaller(decoder, step_mode)
        self._eos_id = int(eos_id)
        self._scorer = scorer or BeamSearchScorer()
        self._max_length = max_length
        self._sync_every = max(1, int(sync_every))

    def _tile_states(self, states, beam):
        return _tile_states(states, beam)

    def _reorder(self, states, idx):
        return _tree_map(lambda x: _tensor(x)[idx], states)

    def __call__(self, inputs, states):
        """inputs: (batch,) first-step ids.  Returns (samples, scores,
        valid_lengths): (batch, beam, L), (batch, beam), (batch, beam)."""
        beam = self._beam_size
        ids = _tensor(inputs)
        dev, dt = ids.device, _ids_dtype(ids)
        batch = ids.shape[0]
        step_input = ids.repeat_interleave(beam, dim=0)      # (B*K,)
        states = self._tile_states(states, beam)
        # the first beam is live, the others -inf: step 1 picks from one
        scores = torch.tensor([0.0] + [-1e18] * (beam - 1),
                              device=dev).repeat(batch).reshape(batch, beam)
        done = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
        lengths = torch.ones((batch, beam), dtype=torch.int32, device=dev)
        sequences = [step_input.reshape(batch, beam).to(dt)]
        rows = torch.arange(batch, device=dev)[:, None] * beam

        for step in range(1, self._max_length + 1):
            lp, states = self._decoder(step_input, states)
            vocab = lp.shape[-1]
            cand = self._scorer(lp.reshape(batch * beam, vocab),
                                scores.reshape(batch * beam),
                                step).reshape(batch, beam, vocab)
            # a finished beam keeps its finish-time score, carried only
            # by its EOS self-loop
            eos_hot = torch.arange(vocab, device=dev) == self._eos_id
            frozen = torch.where(eos_hot[None, None, :], scores[..., None],
                                 -1e18)
            cand = torch.where(done[..., None], frozen, cand)
            top_scores, top_idx = _topk(cand.reshape(batch, beam * vocab),
                                        beam)
            beam_idx = top_idx // vocab                       # (B, K)
            word_idx = (top_idx % vocab).to(torch.int32)
            scores = top_scores
            flat_beam = (rows + beam_idx).reshape(-1)
            done = done.reshape(-1)[flat_beam].reshape(batch, beam)
            lengths = lengths.reshape(-1)[flat_beam].reshape(batch, beam)
            sequences = [s.reshape(-1)[flat_beam].reshape(batch, beam)
                         for s in sequences]
            states = self._reorder(states, flat_beam)
            step_input = word_idx.reshape(-1)
            sequences.append(word_idx.to(dt))
            lengths = torch.where(~done, lengths + 1, lengths)
            done = done | (word_idx == self._eos_id)
            # the early exit: one host read every sync_every steps
            if step % self._sync_every == 0 and bool(done.all()):
                break

        samples = torch.stack(sequences, dim=-1)             # (B, K, L)
        order = torch.argsort(-scores, dim=1, stable=True)
        samples = samples.gather(1, order[..., None].expand_as(samples))
        return (NDArray(samples), NDArray(scores.gather(1, order)),
                NDArray(lengths.gather(1, order)))


def _topk(x, k):
    """The one top-k of the samplers: the k largest of each row, ties
    ordered by the lower index (``jax.lax.top_k``'s order), from a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _tile_states(states, beam):
    return _tree_map(lambda x: _tensor(x).repeat_interleave(beam, dim=0),
                     states)


def _tree_map(fn, states):
    if isinstance(states, (list, tuple)):
        return type(states)(_tree_map(fn, s) for s in states)
    if isinstance(states, dict):
        return {key: _tree_map(fn, v) for key, v in states.items()}
    return fn(states)


class SequenceSampler:
    """Multinomial sequence sampler with temperature (and optional top-k
    truncation through :func:`_topk`).  Reference: gluonnlp
    SequenceSampler.

    Draws come from the ``nd.random`` generator of the inputs' device
    (``ndarray.random.generator``): restoring its state
    (``get_state``/``set_state``) replays a sample exactly.
    ``step_mode``/``sync_every``: see :class:`BeamSearchSampler`."""

    def __init__(self, beam_size, decoder, eos_id, max_length=100,
                 temperature=1.0, top_k=0, step_mode="auto",
                 sync_every=8):
        self._beam_size = beam_size
        self._decoder = _StepCaller(decoder, step_mode)
        self._eos_id = int(eos_id)
        self._max_length = max_length
        self._temperature = temperature
        self._top_k = int(top_k)
        self._sync_every = max(1, int(sync_every))

    def __call__(self, inputs, states):
        beam = self._beam_size
        ids = _tensor(inputs)
        dev, dt = ids.device, _ids_dtype(ids)
        gen = _rnd.generator(dev)
        batch = ids.shape[0]
        step_input = ids.repeat_interleave(beam, dim=0)
        states = _tile_states(states, beam)
        done = torch.zeros(batch * beam, dtype=torch.bool, device=dev)
        lengths = torch.ones(batch * beam, dtype=torch.int32, device=dev)
        scores = torch.zeros(batch * beam, device=dev)
        sequences = [step_input.to(dt)]
        for step in range(1, self._max_length + 1):
            lp, states = self._decoder(step_input, states)
            scaled = lp / self._temperature
            if self._top_k > 0:
                # sample among the k best, then map back to vocab ids
                vals, idx = _topk(scaled, self._top_k)
                pick = _categorical(vals.float(), gen)
                choice = idx.gather(1, pick[:, None])[:, 0]
            else:
                choice = _categorical(scaled.float(), gen)
            choice = torch.where(done, self._eos_id, choice).to(torch.int32)
            taken = lp.gather(1, choice[:, None].long())[:, 0]
            scores = scores + torch.where(done, 0.0, taken)
            lengths = torch.where(done, lengths, lengths + 1)
            sequences.append(choice.to(dt))
            done = done | (choice == self._eos_id)
            step_input = choice
            if step % self._sync_every == 0 and bool(done.all()):
                break
        samples = torch.stack(sequences, dim=-1).reshape(batch, beam, -1)
        return (NDArray(samples), NDArray(scores.reshape(batch, beam)),
                NDArray(lengths.reshape(batch, beam)))
