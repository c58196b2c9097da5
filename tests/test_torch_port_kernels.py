"""The port's kernel modules against the JAX package, on the CPU.

Each case feeds the same numpy inputs (made from a seed) to the JAX
function and to its counterpart in ``mxnet_tpu_torch``.  On CPU tensors
the port's ops run their plain PyTorch versions, which are what the CUDA
kernels are held against on the card (``chip_smoke.py``,
``tests/test_torch_port_cuda.py``).

Tolerances: float32 cases 2e-5 (rtol and atol; the same algorithm, only
the summation order differs between XLA and PyTorch); a bf16 pool holds
the same bf16 codes in both packages and is widened to f32 before the
math, so it keeps 2e-5; a bf16 query rounds the output to bf16, so that
case allows one bf16 ulp of the output's magnitude (8e-3 relative).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.ops import paged_decode_attention as jax_paged
from mxnet_tpu.ops.paged_attention import _fallback as jax_paged_fallback

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)
from mxnet_tpu_torch.ops.fused_layernorm import bwd_plan, fwd_plan
from mxnet_tpu_torch.ops.fused_update import update_plan
from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                 split_plan)
from mxnet_tpu_torch.ops.quant_kv import resolve_kv_dtype

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_CASES = [(causal, L, D) for causal in (False, True)
               for L in (16, 128) for D in (16, 64, 128)]


def _jax_flash_module():
    # ``mxnet_tpu.ops`` re-exports the function under the module's name
    import mxnet_tpu.ops  # noqa: F401
    return sys.modules["mxnet_tpu.ops.flash_attention"]


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# ----------------------------------------------------------------------
# flash attention (K3)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,L,D", FLASH_CASES)
def test_flash_matches_jax_scan_forward(causal, L, D):
    """(out, lse) of the port's op vs the reference's ``_flash_fwd``,
    which on the CPU is the blockwise ``_scan_forward``."""
    mod = _jax_flash_module()
    q, k, v = _qkv(L + D, (3, L, D))
    scale = 1.0 / np.sqrt(D)
    ref_out, res = mod._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, scale)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), **TOL)


@pytest.mark.parametrize("causal,lq,lk", [
    (False, 48, 48), (True, 48, 48), (False, 48, 96),
    # causal cross-attention lengths (top-left mask), one at a 64-row edge
    (True, 48, 96), (True, 130, 70), (True, 64, 129)])
def test_flash_public_layout_matches_jax(causal, lq, lk):
    """The (B, H, L, D) public op, cross-attention lengths included."""
    from mxnet_tpu.ops import flash_attention as jax_flash
    rng = np.random.RandomState(11)
    q = rng.randn(2, 3, lq, 64).astype(np.float32)
    k = rng.randn(2, 3, lk, 64).astype(np.float32)
    v = rng.randn(2, 3, lk, 64).astype(np.float32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert out.shape == (2, 3, lq, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_bf16_rounds_p_like_the_reference():
    """bf16 inputs: p is rounded to bf16 before the PV product in both
    packages (``_scan_forward`` casts ``p.astype(v.dtype)``)."""
    mod = _jax_flash_module()
    q, k, v = _qkv(5, (2, 128, 64))
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref, _ = mod._scan_forward(qb, kb, vb, True, 0.125, 128)
    out, _ = flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        True, 0.125, 128)
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref32, rtol=8e-3,
                               atol=8e-3)


_PALLAS_SCRIPT = r"""
import functools, json, sys
import numpy as np
from unittest import mock
import jax.numpy as jnp
from jax.experimental import pallas as pl
import mxnet_tpu.ops
mod = sys.modules["mxnet_tpu.ops.flash_attention"]
cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
res = {}
interp = functools.partial(pl.pallas_call, interpret=True)
for causal, L, D in cases:
    rng = np.random.RandomState(L + D)
    q, k, v = (jnp.asarray(rng.randn(3, L, D).astype(np.float32))
               for _ in range(3))
    with mock.patch.object(pl, "pallas_call", interp):
        o, lse = mod._pallas_forward(q, k, v, causal, 1.0 / np.sqrt(D), L, L)
    res[f"{int(causal)}_{L}_{D}_out"] = np.asarray(o)
    res[f"{int(causal)}_{L}_{D}_lse"] = np.asarray(lse)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module")
def pallas_interpret_results(tmp_path_factory):
    """The reference's Pallas kernel run in interpret mode, in a child
    process: this test process pins JAX to the CPU backend, where the
    Pallas TPU lowering rules cannot register."""
    out = tmp_path_factory.mktemp("pallas") / "flash.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", _PALLAS_SCRIPT,
         json.dumps(FLASH_CASES), str(out)],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("causal,L,D", FLASH_CASES)
def test_flash_matches_pallas_kernel_interpret(pallas_interpret_results,
                                               causal, L, D):
    q, k, v = _qkv(L + D, (3, L, D))
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    key = f"{int(causal)}_{L}_{D}"
    np.testing.assert_allclose(out.numpy(),
                               pallas_interpret_results[key + "_out"], **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               pallas_interpret_results[key + "_lse"], **TOL)


# ----------------------------------------------------------------------
# paged decode attention (K5)
# ----------------------------------------------------------------------

def _paged_inputs(seed, B=4, h=4, kvh=2, d=16, num_blocks=16, bs=4, nbl=3):
    """Pools, scattered block tables (out-of-order physical blocks, 0 as
    null padding) and mixed positions, as numpy; GQA rep = h / kvh."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, h, d).astype(np.float32)
    kp = rng.randn(num_blocks, bs, kvh, d).astype(np.float32)
    vp = rng.randn(num_blocks, bs, kvh, d).astype(np.float32)
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    tables[0] = perm[:nbl]                      # full context
    tables[1, :2] = perm[nbl:nbl + 2]           # 2 blocks + null pad
    tables[2, :1] = perm[nbl + 2:nbl + 3]       # mid-first-block
    pos = np.array([nbl * bs - 1, bs + 1, 1, 0], np.int32)  # row 3 idle
    return q, kp, vp, tables, pos, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_paged_matches_jax(q_dtype, pool_dtype):
    q, kp, vp, tables, pos, scale = _paged_inputs(0)
    jq = jnp.asarray(q, getattr(jnp, q_dtype))
    jk, jv = (jnp.asarray(a, getattr(jnp, pool_dtype)) for a in (kp, vp))
    ref = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos), scale)
    ref_fb = jax_paged_fallback(jq, jk, jv, jnp.asarray(tables),
                                jnp.asarray(pos), scale)
    assert np.array_equal(np.asarray(ref), np.asarray(ref_fb))
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, pool_dtype))
              for a in (kp, vp))
    out = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(pos), scale)
    assert out.shape == (4, 4 * 16) and out.dtype == tq.dtype
    tol = TOL if q_dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


def test_paged_masks_write_ahead_garbage():
    """Positions past ``pos`` (write-ahead rows, null padding) contribute
    nothing: poisoning them leaves the output bitwise unchanged."""
    q, kp, vp, tables, pos, scale = _paged_inputs(2)
    args = (torch.from_numpy(tables), torch.from_numpy(pos), scale)
    out = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), *args)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[tables[1, 2]] = 1e6                      # row 1's null pad block
    vp2[tables[1, 2]] = -1e6
    kp2[tables[2, 0], 2:] = 1e6                  # row 2 sees 0..1 only
    vp2[tables[2, 0], 2:] = -1e6
    out2 = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp2),
                                  torch.from_numpy(vp2), *args)
    assert torch.equal(out2[1], out[1]) and torch.equal(out2[2], out[2])


@pytest.mark.parametrize("nbl,bs,want", [
    (64, 16, (128, 8)),           # phase 3's table: 1024 positions
    (256, 16, (128, 32)),         # the fp8 serving phase's 4096
    (4, 16, (128, 1)),            # a short bucket: one split
    (1, 16, (128, 1)),
    (65, 16, (128, 9)),           # a ragged last split
    (32, 32, (128, 8)),
    (64, 8, (128, 4)),
    (8, 48, (96, 4)),             # C rounds down to whole blocks
    (3, 256, (256, 3)),           # at least one block a split
    (600, 1, (128, 5)),
    (4096, 16, (128, 512))])      # the most splits the kernel merges
def test_paged_split_plan(nbl, bs, want):
    """K5's grid (B, KVH, S): S splits of C positions cover the table's
    nbl * bs positions, C a multiple of bs."""
    c, s = split_plan(nbl, bs)
    assert (c, s) == want
    assert c % bs == 0 and s * c >= nbl * bs > (s - 1) * c


@pytest.mark.parametrize("rows,d,want", [
    (4096, 1024, (1, 264)),       # BERT-large: a warp a row, 2 CTAs a SM
    (4096, 768, (1, 264)),
    (4096, 100, (1, 264)),
    (7, 64, (1, 1)),              # 8 row groups a CTA: one CTA
    (33, 1025, (2, 9)),           # 4 groups of 2 warps a CTA
    (4097, 2048, (2, 264)),
    (33, 4096, (4, 17)),
    (33, 8192, (8, 33)),          # one row a CTA
    (1, 8192, (8, 1))])
def test_layernorm_bwd_plan(rows, d, want):
    """K4 backward: warps a row and the persistent grid at 132 SMs with 2
    resident CTAs each."""
    assert bwd_plan(rows, d, 132, 2) == want


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("rows", [1, 7, 4096, 4097])
@pytest.mark.parametrize("d", [1, 100, 1024, 1025, 2048, 8192])
def test_layernorm_fwd_plan(d, rows, resident):
    """K4 forward: the fewest warps a row (a power of two up to 8) whose
    32 lanes of 32 columns hold the row, and a plain grid whose row
    groups (8 / warps a CTA) cover the rows with less than a CTA to
    spare; the backward takes the same warps a row, over at most the
    resident CTAs at 132 SMs."""
    wpr, ctas = fwd_plan(rows, d)
    assert wpr in (1, 2, 4, 8)
    assert wpr * 1024 >= d and (wpr == 1 or wpr * 512 < d)
    groups = 8 // wpr
    assert ctas * groups >= rows > (ctas - 1) * groups
    assert bwd_plan(rows, d, 132, resident) == \
        (wpr, min(ctas, 132 * resident))


@pytest.mark.parametrize("ctas", [1, 2])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4099, 1 << 20])
@pytest.mark.parametrize("offsets", [
    (0, 0, 0, 0), (1, 1, 1, 1), (2, 2, 2), (3, 3),   # equal: a vector plan
    (0, 1, 0, 0), (2, 0), (3, 3, 1)],                # mixed: all scalar
    ids=["equal0", "equal1", "equal2", "equal3", "mixed01", "mixed20",
         "mixed31"])
def test_update_vector_plan(offsets, n, ctas):
    """K1/K2's launch plan: a scalar head that aligns every stream to 16
    bytes, float4s, a scalar tail, on a persistent grid of 132 SMs; a
    bucket whose streams sit at different offsets is all scalar."""
    ptrs = [(k + 1) * (1 << 36) + 4 * off for k, off in enumerate(offsets)]
    head, nvec, tail, grid = update_plan(ptrs, n, 132, ctas)
    assert head + 4 * nvec + tail == n
    assert min(head, nvec, tail) >= 0 and 1 <= grid <= 132 * ctas
    if len(set(offsets)) == 1:
        assert head < 4 and tail < 4
        assert head == min(n, (4 - offsets[0]) % 4)
        assert all((p + 4 * head) % 16 == 0 for p in ptrs) or nvec == 0
        # 256 threads of 4 float4s each: the fewest CTAs that cover it
        need = -(-nvec // 1024)
    else:
        assert (head, nvec, tail) == (n, 0, 0)
        need = -(-n // 256)
    assert grid == max(1, min(132 * ctas, need))


# ----------------------------------------------------------------------
# routing, storage modes, build
# ----------------------------------------------------------------------

def test_ops_refuse_devices_they_do_not_serve():
    q = torch.empty(2, 16, 64, device="meta")
    with pytest.raises(mt.MXNetError):
        flash_attention_fwd(q, q, q)
    with pytest.raises(mt.MXNetError):
        paged_decode_attention(torch.empty(2, 4, 64, device="meta"),
                               torch.empty(3, 4, 2, 64, device="meta"),
                               torch.empty(3, 4, 2, 64, device="meta"),
                               torch.zeros(2, 1, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 0.125)


def test_kv_dtype_subset():
    assert resolve_kv_dtype(None) is None
    assert resolve_kv_dtype("fp32") is None
    assert resolve_kv_dtype("bfloat16") == "bf16"
    assert resolve_kv_dtype("fp8") == "fp8"
    with pytest.raises(mt.MXNetError):
        resolve_kv_dtype("int4")


@pytest.mark.parametrize("value", ["0", "off", "OFF", " none ", ""])
def test_kv_dtype_off_values_resolve_to_none(value):
    """The reference's kill-switch spellings keep the model's dtype."""
    assert resolve_kv_dtype(value) is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    real_exists = os.path.exists
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: (
        False if p.endswith(("nvcc", ".so")) else real_exists(p)))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(mt.MXNetError, match="nvcc"):
        _build.build(["flash_attention"])


def test_build_target_tracks_source_bytes():
    """The library name carries a hash of the kernel's source and the
    shared header, so each kernel has its own, stable target."""
    a = _build._target("flash_attention")
    assert a == _build._target("flash_attention")
    assert a != _build._target("paged_attention")
    assert a.startswith(_build.BUILD_DIR) and a.endswith(".so")


# ----------------------------------------------------------------------
# isolation: the port never imports JAX or the JAX package
# ----------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "tools").glob("port_*.py"))
    files.append(REPO / "chip_smoke.py")
    # the training entry point, checkpointing and int8 quantization are
    # covered too
    port = REPO / "mxnet_tpu_torch"
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/data_parallel.py", "checkpoint.py",
                "contrib/__init__.py", "contrib/quantization.py",
                "ops/quant_matmul.py", "serving/frontend/router.py",
                "testing/__init__.py", "testing/faults.py"):
        assert port / rel in files, rel
    assert REPO / "tools" / "port_serve_loadgen.py" in files
    bad = []
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "mxnet_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert len(files) > 10 and not bad, bad
