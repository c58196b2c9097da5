"""Word-level language models: ``StandardRNN`` and ``AWDRNN``.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/language_model.py``
(GluonNLP's ``language_model.py``): embedding, stacked recurrent layers
of ``gluon.rnn`` and a tied or separate output projection, with the
five factories ``standard_lstm_lm_{200,650,1500}`` and
``awd_lstm_lm_{1150,600}``.  As in the reference, ``AWDRNN``'s
``weight_drop`` is taken and not applied: its regularizers are
variational dropouts whose masks are shared over an axis (``drop_e``
whole word vectors, ``drop_i``/``drop_h``/``dropout`` over time).  A
call takes ``(inputs, begin_state=None)``, ``inputs`` (seq_len, batch)
token ids, and returns ``(logits (seq_len, batch, vocab), states)``;
hybridized, the whole model, recurrence included, is one CachedOp.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn, rnn

__all__ = ["StandardRNN", "AWDRNN", "standard_lstm_lm_200",
           "standard_lstm_lm_650", "standard_lstm_lm_1500",
           "awd_lstm_lm_1150", "awd_lstm_lm_600"]


def _make_rnn(mode, hidden_size, num_layers, dropout, input_size, prefix):
    if mode == "lstm":
        return rnn.LSTM(hidden_size, num_layers, dropout=dropout,
                        input_size=input_size, prefix=prefix)
    if mode == "gru":
        return rnn.GRU(hidden_size, num_layers, dropout=dropout,
                       input_size=input_size, prefix=prefix)
    if mode in ("rnn_tanh", "rnn_relu"):
        return rnn.RNN(hidden_size, num_layers, dropout=dropout,
                       input_size=input_size,
                       activation=mode.split("_")[1], prefix=prefix)
    raise ValueError(f"unknown RNN mode {mode!r}")


class StandardRNN(HybridBlock):
    """Embedding, stacked recurrent layers, (tied) output projection
    (reference GluonNLP ``StandardRNN``)."""

    def __init__(self, mode="lstm", vocab_size=33278, embed_size=200,
                 hidden_size=200, num_layers=2, dropout=0.5,
                 tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        if tie_weights and embed_size != hidden_size:
            raise ValueError(
                f"Embedding dimension {embed_size} must equal hidden "
                f"dimension {hidden_size} when tie_weights=True")
        self._mode = mode
        self._vocab_size = vocab_size
        self._tie_weights = tie_weights
        with self.name_scope():
            self.embedding = nn.HybridSequential(prefix="embedding_")
            with self.embedding.name_scope():
                self.embedding.add(nn.Embedding(vocab_size, embed_size))
                if dropout:
                    self.embedding.add(nn.Dropout(dropout))
            self.encoder = _make_rnn(mode, hidden_size, num_layers, dropout,
                                     embed_size, prefix="encoder_")
            if not tie_weights:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        prefix="decoder_")

    def begin_state(self, batch_size=1, **kwargs):
        return self.encoder.begin_state(batch_size=batch_size, **kwargs)

    def hybrid_forward(self, F, inputs, begin_state=None):
        emb = self.embedding(inputs)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=inputs.shape[1],
                                           ctx=inputs.context)
        out, state = self.encoder(emb, begin_state)
        if self._tie_weights:
            w = self.embedding[0].weight.data()
            logits = F.dot(out, w, transpose_b=True)
        else:
            logits = self.decoder(out)
        return logits, state


class AWDRNN(HybridBlock):
    """AWD-LSTM (Merity et al.; reference GluonNLP ``AWDRNN``): one
    single-layer recurrent layer a level, ``hidden_size`` units but the
    last, which has ``embed_size`` when the weights are tied."""

    def __init__(self, mode="lstm", vocab_size=33278, embed_size=400,
                 hidden_size=1150, num_layers=3, tie_weights=True,
                 dropout=0.4, weight_drop=0.5, drop_h=0.2, drop_i=0.65,
                 drop_e=0.1, **kwargs):
        super().__init__(**kwargs)
        self._tie_weights = tie_weights
        self._vocab_size = vocab_size
        with self.name_scope():
            self.embedding = nn.Embedding(vocab_size, embed_size,
                                          prefix="embedding_")
            # (L, B, C): axis 2 shared, so whole word vectors drop
            self.embedding_dropout = nn.Dropout(drop_e, axes=(2,))
            self.input_dropout = nn.Dropout(drop_i, axes=(0,))
            self.encoders = nn.HybridSequential(prefix="encoders_")
            with self.encoders.name_scope():
                for i in range(num_layers):
                    last = i == num_layers - 1
                    units = embed_size if (last and tie_weights) \
                        else hidden_size
                    in_units = embed_size if i == 0 else hidden_size
                    self.encoders.add(_make_rnn(
                        mode, units, 1, 0.0, in_units, prefix=f"layer{i}_"))
            self.hidden_dropout = nn.Dropout(drop_h, axes=(0,))
            self.output_dropout = nn.Dropout(dropout, axes=(0,))
            if not tie_weights:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        prefix="decoder_")

    def begin_state(self, batch_size=1, **kwargs):
        return [enc.begin_state(batch_size=batch_size, **kwargs)
                for enc in self.encoders._children.values()]

    def hybrid_forward(self, F, inputs, begin_state=None):
        emb = self.input_dropout(self.embedding_dropout(
            self.embedding(inputs)))
        if begin_state is None:
            begin_state = self.begin_state(batch_size=inputs.shape[1],
                                           ctx=inputs.context)
        out = emb
        states = []
        encoders = list(self.encoders._children.values())
        for i, (enc, st) in enumerate(zip(encoders, begin_state)):
            out, new_st = enc(out, st)
            states.append(new_st)
            if i != len(encoders) - 1:
                out = self.hidden_dropout(out)
        out = self.output_dropout(out)
        if self._tie_weights:
            logits = F.dot(out, self.embedding.weight.data(),
                           transpose_b=True)
        else:
            logits = self.decoder(out)
        return logits, states


def standard_lstm_lm_200(vocab_size=33278, **kwargs):
    return StandardRNN("lstm", vocab_size, 200, 200, 2, dropout=0.2,
                       tie_weights=True, **kwargs)


def standard_lstm_lm_650(vocab_size=33278, **kwargs):
    return StandardRNN("lstm", vocab_size, 650, 650, 2, dropout=0.5,
                       tie_weights=True, **kwargs)


def standard_lstm_lm_1500(vocab_size=33278, **kwargs):
    return StandardRNN("lstm", vocab_size, 1500, 1500, 2, dropout=0.65,
                       tie_weights=False, **kwargs)


def awd_lstm_lm_1150(vocab_size=33278, **kwargs):
    return AWDRNN("lstm", vocab_size, 400, 1150, 3, **kwargs)


def awd_lstm_lm_600(vocab_size=33278, **kwargs):
    return AWDRNN("lstm", vocab_size, 200, 600, 3, **kwargs)
