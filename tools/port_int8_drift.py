#!/usr/bin/env python3
"""How far int8 weight serving moves Llama-3-8B's logits, on one NVIDIA
GPU, against how far the activations' dtype alone moves them.

    python3 tools/port_int8_drift.py [--layers 2 8]

One Llama-3-8B at full width and depth (bfloat16, random weights drawn
on the card from seed 0) serves the prefill of the first prompt of
``chip_smoke.SERVING_CELLS["bf16"]`` cut to 5, 16, 64, 256 tokens and
whole, through ``InferenceEngine(max_batch=2, block_size=16,
max_context=1024)``, four ways:

- ``bf16``: the net as it is (phase 4's engine);
- ``f32``: the same weight values in a float32 net (float32
  activations, as the int8 path's);
- ``int8``: the bf16 net after ``contrib.quantization.quantize_net``
  on ``chip_smoke.int8_calibration`` (phase 23's 2 seeded batches of
  2 x 12 tokens), served with ``quantize="int8"``;
- and the int8 path again on nets cut to ``--layers`` layers, against
  their own bf16 prefill.

Each line gives, by prompt length, the largest |logit| difference over
the largest |logit| of the reference (the form of the reference's
serving bound, ``|drift| <= 0.05 * max|logit|``).  The card's name and
power limit come first, a JSON summary last.
"""
import argparse
import gc
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="*", default=[2, 8])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the engines run on the card")
    sys.path.insert(0, REPO)
    import chip_smoke
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 means fp32
    card = chip_smoke.card_line()
    print(card, flush=True)
    vocab = 128256
    prompts, _ = chip_smoke.serving_prompts(chip_smoke.SERVING_CELLS["bf16"],
                                            vocab)
    prompt = prompts[0].tolist()
    lengths = [5, 16, 64, 256, len(prompt)]

    def prefill_logits(net, **kw):
        eng = serving.InferenceEngine(net, max_batch=2, block_size=16,
                                      max_context=1024, device=dev, **kw)
        out = {}
        for n in lengths:
            _, last = eng.prefill(n, prompt[:n])
            out[n] = last.float().clone()
            eng.release(n)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def drift(got, ref, label):
        ratio = {n: float((got[n] - ref[n]).abs().max()) /
                 float(ref[n].abs().max()) for n in lengths}
        print(f"{label}: max |drift| / max |logit| by prompt length "
              f"{ {n: round(r, 4) for n, r in ratio.items()} }", flush=True)
        return ratio

    def calib():
        return chip_smoke.int8_calibration(vocab, dev, 23)

    summary = {"card": card, "lengths": lengths}
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0)
    bf16 = prefill_logits(net)
    f32_net = chip_smoke.copy_weights(
        net, llama3_8b(device=dev, dtype=torch.float32))
    f32 = prefill_logits(f32_net)
    del f32_net
    summary["f32_vs_bf16"] = drift(f32, bf16, "f32 activations vs bf16")
    quantize_net(net, calib_data=calib(), num_calib_batches=2)
    int8 = prefill_logits(net, quantize="int8")
    del net
    summary["int8_vs_bf16"] = drift(int8, bf16, "int8 vs bf16")
    summary["int8_vs_f32"] = drift(int8, f32, "int8 vs f32")
    for layers in args.layers:
        cut = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0,
                        num_layers=layers)
        ref = prefill_logits(cut)
        quantize_net(cut, calib_data=calib(), num_calib_batches=2)
        summary[f"int8_vs_bf16_{layers}_layers"] = drift(
            prefill_logits(cut, quantize="int8"), ref,
            f"{layers} layers, int8 vs bf16")
        del cut
        gc.collect()
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
