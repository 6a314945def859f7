"""K1–K9 on the card against their plain PyTorch versions.

Needs a CUDA device (marker ``gpu``); without one every test here skips.
This file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ragged_gather import ops, ref  # noqa: E402

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}


def _data(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _tables(rng, P, buf_rows, rows):
    """Starts in range, negative and past the end; valid counts of 0, all
    rows, a prefix and out of range."""
    start = rng.integers(-rows - 3, buf_rows + 4, size=P).astype(np.int32)
    start[0], start[-1] = -2 * buf_rows, buf_rows + 5
    valid = rng.choice([0, rows, max(0, rows // 2), rows + 9, -2],
                       size=P).astype(np.int32)
    return torch.from_numpy(start), torch.from_numpy(valid)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slab kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cuda_kernels_match_plain(cuda_device, dname):
    """K1–K3 on the card, bitwise against their plain versions on the same
    CUDA inputs, and each launch counted."""
    tdt = DTYPES[dname]
    rng = np.random.default_rng(21)
    P, buf_rows, rows, F = 16, 300, 40, 64
    buf = _data(rng, (P, buf_rows, F), tdt).to(cuda_device)
    slab = _data(rng, (P, rows, F), tdt).to(cuda_device)
    start, valid = (t.to(cuda_device) for t in _tables(rng, P, buf_rows, rows))
    send = start.roll(1)
    ops.reset_launches()
    assert torch.equal(ops.slab_extract(buf, start, rows),
                       ref.slab_extract_ref(buf, start, rows))
    assert torch.equal(ops.slab_merge(buf.clone(), slab, start, valid),
                       ref.slab_merge_ref(buf.clone(), slab, start, valid))
    kb, ko = ops.slab_step(buf.clone(), slab, start, valid, send, rows + 3)
    pb, po = ref.slab_step_ref(buf.clone(), slab, start, valid, send, rows + 3)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(ko, po)
    assert ops.LAUNCHES == {"slab_extract": 1, "slab_merge": 1,
                            "slab_step": 1, "slab_merge_add": 0,
                            "slab_step_reduce": 0, "ragged_gather": 0,
                            "ragged_scatter": 0, "flash_attention": 0,
                            "rglru_scan": 0}


def _send_windows(start, rows_in, rows_out):
    """Send starts that overlap each rank's merge window fully, partly
    from above, partly from below (ss < rs), or not at all."""
    shift = torch.tensor([0, rows_in // 2, -(rows_out // 2), 3 * rows_in],
                         dtype=torch.int32)
    return start + shift.repeat(len(start) // 4 + 1)[: len(start)]


@pytest.mark.gpu
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cuda_reduce_kernels_match_plain(cuda_device, dname):
    """K4 and K5 on the card, bitwise against their plain versions on the
    same CUDA inputs (both add once per element in the working dtype),
    with out-of-range starts and valid counts and overlapping send and
    merge windows; each launch counted."""
    tdt = DTYPES[dname]
    rng = np.random.default_rng(22)
    P, buf_rows, rows, F = 16, 300, 40, 64
    buf = _data(rng, (P, buf_rows, F), tdt).to(cuda_device)
    slab = _data(rng, (P, rows, F), tdt).to(cuda_device)
    start, valid = (t.to(cuda_device) for t in _tables(rng, P, buf_rows, rows))
    ops.reset_launches()
    assert torch.equal(ops.slab_merge_add(buf.clone(), slab, start, valid),
                       ref.slab_merge_add_ref(buf.clone(), slab, start, valid))
    for rows_out in (rows, rows + 3, 7):
        send = _send_windows(start.cpu(), rows, rows_out).to(cuda_device)
        kb, ko = ops.slab_step_reduce(buf.clone(), slab, start, valid, send,
                                      rows_out)
        pb, po = ref.slab_step_reduce_ref(buf.clone(), slab, start, valid,
                                          send, rows_out)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(ko, po), rows_out
    assert ops.LAUNCHES["slab_merge_add"] == 1
    assert ops.LAUNCHES["slab_step_reduce"] == 3


@pytest.mark.gpu
def test_cuda_masked_add_keeps_negative_zero(cuda_device):
    buf = torch.full((2, 8, 4), -0.0, device=cuda_device)
    slab = torch.ones((2, 8, 4), device=cuda_device)
    z = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    out = ops.slab_merge_add(buf, slab, z, z)
    _, nxt = ops.slab_step_reduce(buf, slab, z, z, z, 8)
    torch.cuda.synchronize()
    assert torch.signbit(out).all() and torch.signbit(nxt).all()


@pytest.mark.gpu
def test_cuda_kernels_reject_misaligned_rows(cuda_device):
    buf = torch.zeros((2, 8, 3), device=cuda_device)   # 12-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        ops.slab_extract(buf, torch.zeros(2, dtype=torch.int32,
                                          device=cuda_device), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [1, 4])
def test_cuda_gatherv_scatterv_small(cuda_device, segments):
    """The main path on the card at a small size, bitwise against the
    oracles, with all three kernels launched."""
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes

    mesh = rt.LocalMesh(8)
    rng = np.random.default_rng(segments)
    ops.reset_launches()
    for name in NAMES:
        blocks = [rng.standard_normal((s, 8)).astype(np.float32)
                  for s in block_sizes(name, 8, 9, seed=1)]
        want = np.concatenate(blocks)
        got, _ = rt.run_gatherv(mesh, blocks, 5, segments=segments)
        np.testing.assert_array_equal(got, want)
        outs, _ = rt.run_scatterv(mesh, want, [len(b) for b in blocks], 5,
                                  segments=segments)
        for o, b in zip(outs, blocks):
            np.testing.assert_array_equal(o, b)
    assert all(ops.LAUNCHES[k] > 0 for k in
               ("slab_extract", "slab_merge", "slab_step")), ops.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("segments", [1, 4])
def test_cuda_reduce_and_composed_small(cuda_device, segments):
    """The reduction and composed paths on the card at a small size,
    bitwise against the port's NumPy executors and ``np.concatenate``,
    with K1–K5 all launched."""
    import repro_torch as rt
    from repro_torch.core.distributions import NAMES, block_sizes
    from repro_torch.core.pipeline import (execute_allreducev_plan_numpy,
                                           execute_reduce_scatterv_plan_numpy)

    mesh = rt.LocalMesh(8)
    rng = np.random.default_rng(segments)
    ops.reset_launches()
    for name in NAMES:
        sizes = block_sizes(name, 8, 9, seed=1)
        contribs = [rng.standard_normal((sum(sizes), 8)).astype(np.float32)
                    for _ in range(8)]
        outs, plan = rt.run_reduce_scatterv(mesh, contribs, sizes,
                                            segments=segments)
        for a, b in zip(outs, execute_reduce_scatterv_plan_numpy(plan,
                                                                 contribs)):
            np.testing.assert_array_equal(a, b)
        out, plan = rt.run_allreducev(mesh, contribs, sizes,
                                      segments=segments)
        for a, b in zip(out, execute_allreducev_plan_numpy(plan, contribs)):
            np.testing.assert_array_equal(a, b)
        blocks = [c[: s] for c, s in zip(contribs, sizes)]
        out, _ = rt.run_allgatherv(mesh, blocks, segments=segments)
        for copy in out:
            np.testing.assert_array_equal(copy, np.concatenate(blocks))
        S = [block_sizes(name, 8, 5, seed=i) for i in range(8)]
        matrix = [[rng.standard_normal((S[i][j], 8)).astype(np.float32)
                   for j in range(8)] for i in range(8)]
        res, _ = rt.run_alltoallv(mesh, matrix, segments=segments)
        for j in range(8):
            np.testing.assert_array_equal(
                res[j], np.concatenate([matrix[i][j] for i in range(8)]))
    assert all(ops.LAUNCHES[k] > 0 for k in
               ("slab_extract", "slab_merge", "slab_step", "slab_merge_add",
                "slab_step_reduce")), ops.LAUNCHES


# (name, rows, F, dtype): 16-byte rows, the odd 28-byte fp32 row, int32,
# 6-byte fp16 rows and single bytes
PACK_CASES = [("fp32-aligned", 300, 64, torch.float32),
              ("fp32-F7", 300, 7, torch.float32),
              ("int32", 257, 12, torch.int32),
              ("fp16-F3", 100, 3, torch.float16),
              ("uint8-F5", 100, 5, torch.uint8)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PACK_CASES, ids=[c[0] for c in PACK_CASES])
def test_cuda_pack_kernels_match_plain(cuda_device, case):
    """K6 and K7 on the card, bitwise against their plain versions, with
    indices in range, negative and past the end, and pack -> unpack."""
    _, n, f, tdt = case
    rng = np.random.default_rng(n + f)
    if tdt.is_floating_point:
        x = _data(rng, (n, f), torch.float32).to(tdt)
    else:
        x = torch.from_numpy(rng.integers(0, 100, size=(n, f))).to(tdt)
    x = x.to(cuda_device)
    idx = rng.integers(-5, n + 5, size=3 * n).astype(np.int32)
    idx = torch.from_numpy(idx).to(cuda_device)
    ops.reset_launches()
    assert torch.equal(ops.ragged_gather(x, idx), ref.ragged_gather_ref(x, idx))
    dst = rng.permutation(n + 40)[:n] - 20          # injective, some dropped
    dst = torch.from_numpy(dst.astype(np.int32)).to(cuda_device)
    assert torch.equal(ops.ragged_scatter(x, dst, n),
                       ref.ragged_scatter_ref(x, dst, n))
    sizes = torch.tensor([5, 0, 17, 3], dtype=torch.int32, device=cuda_device)
    blocks = x[: 4 * 20].reshape(4, 20, f)
    packed = ops.pack_blocks(blocks, sizes, 30)
    assert torch.equal(packed, ref.pack_blocks_ref(blocks, sizes, 30))
    back = ops.unpack_blocks(packed, sizes, 20)
    keep = torch.arange(20, device=cuda_device)[None, :] < sizes[:, None]
    assert torch.equal(back, torch.where(keep[..., None], blocks, 0))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ragged_gather"] == 2
    assert ops.LAUNCHES["ragged_scatter"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [1, 2])
def test_cuda_moe_small(cuda_device, groups):
    """A small MoE layer on the card: the K6 gathers against the plain
    versions (``use_kernel_dataplane(False)``), bitwise, in bf16 and with
    tokens dropped by the capacity."""
    import dataclasses

    import repro_torch as rt

    cfg = rt.get_config("mixtral-8x7b").reduced()
    moe = dataclasses.replace(cfg.moe, dispatch_groups=groups)
    layer = rt.MoE(cfg.d_model, moe, dtype=torch.bfloat16, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((4, 32, cfg.d_model), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    for capacity in (None, 5):
        ops.reset_launches()
        out, aux = layer(x, capacity)
        assert ops.LAUNCHES["ragged_gather"] == 2
        try:
            rt.use_kernel_dataplane(False)
            want, waux = layer(x, capacity)
        finally:
            rt.use_kernel_dataplane(None)
        assert torch.equal(out, want)
        assert torch.equal(aux["load"], waux["load"])
        assert int(aux["dropped"]) == int(waux["dropped"])
    assert int(aux["dropped"]) > 0


# The narrowest row (bytes) that K6's bulk kernel takes (kBulkMinBytes in
# csrc/pack.cu); narrower rows take its unit kernel.
K6_BULK_MIN_BYTES = 384


def _gather_cases():
    """(id, N, M, F, dtype, index kind, x misaligned) of the K6 sweep; the
    widths around the bulk kernel's threshold are added in the test."""
    return [("bf16-8KB-M>>grid", 1025, 20000, 4096, torch.bfloat16, "mix",
             False),
            ("fp32-F1024", 4097, 10248, 1024, torch.float32, "mix", False),
            ("fp32-16B", 300, 1000, 4, torch.float32, "mix", False),
            ("fp32-16KB-split", 50, 300, 4096, torch.float32, "mix", False),
            ("bf16-20KB-split", 40, 77, 10240, torch.bfloat16, "mix", False),
            ("fp32-4KB-misaligned", 300, 1000, 1024, torch.float32, "mix",
             True),
            ("fp32-4KB-M1", 300, 1, 1024, torch.float32, "mix", False),
            ("fp32-4KB-M=4k+3", 300, 4 * 97 + 3, 1024, torch.float32, "mix",
             False),
            ("bf16-8KB-all-sentinel", 100, 999, 4096, torch.bfloat16,
             "sentinel", False),
            ("fp32-4KB-out-of-range", 300, 1000, 1024, torch.float32,
             "outside", False)]


GATHER_IDS = [c[0] for c in _gather_cases()] + [
    "threshold-16", "threshold", "threshold+16"]


def _gather_index(rng, kind, n, m):
    if kind == "sentinel":        # every slot empty: the zero row n - 1
        return np.full(m, n - 1, dtype=np.int32)
    if kind == "outside":         # below 0 and past the end only
        return np.where(rng.random(m) < 0.5,
                        rng.integers(-2**31, 0, size=m),
                        rng.integers(n, 2**31 - 1, size=m)).astype(np.int32)
    idx = rng.integers(-5, n + 5, size=m).astype(np.int32)
    idx[rng.random(m) < 0.2] = n - 1   # repeats of the sentinel row
    return idx


@pytest.mark.gpu
@pytest.mark.parametrize("which", GATHER_IDS)
def test_cuda_ragged_gather_bulk_sweep(cuda_device, which):
    """K6 across its two kernels, bitwise against its plain version: rows
    at, and 16 bytes either side of, the bulk kernel's threshold; 8 KB
    bf16 rows with M far above the grid; rows wider than a ring stage; an
    ``x`` 8 but not 16 bytes aligned (the unit kernel); M = 1 and M not a
    multiple of a stage's rows; all indices on the sentinel row; indices
    only below 0 and past N."""
    cases = {c[0]: c for c in _gather_cases()}
    thr = K6_BULK_MIN_BYTES
    for name, w in (("threshold-16", thr - 16), ("threshold", thr),
                    ("threshold+16", thr + 16)):
        cases[name] = (name, 300, 1000, w // 4, torch.float32, "mix", False)
    _, n, m, f, tdt, kind, misaligned = cases[which]
    rng = np.random.default_rng(n + m + f)
    data = _data(rng, (n * f + 8,), torch.float32).to(tdt).to(cuda_device)
    off = 8 // data.element_size() if misaligned else 0
    x = data[off:off + n * f].view(n, f)
    assert (x.data_ptr() % 16 != 0) == misaligned
    x[n - 1] = 0
    idx = torch.from_numpy(_gather_index(rng, kind, n, m)).to(cuda_device)
    ops.reset_launches()
    got = ops.ragged_gather(x, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ragged_gather"] == 1
    assert torch.equal(got, ref.ragged_gather_ref(x, idx))


# K1's sweep: row bytes -> (buf_rows, rows counts).  Each list holds 1, 7,
# a count whose window is not a whole number of 16 KB chunks (16 KB rows
# make every window whole) and buf_rows.
EXTRACT_ROWS = {16: (2000, (1, 7, 1500, 2000)),
                4112: (40, (1, 7, 13, 40)),
                16384: (48, (1, 7, 37, 48))}


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 3, 16, 64])
@pytest.mark.parametrize("row_bytes", sorted(EXTRACT_ROWS))
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cuda_slab_extract_sweep(cuda_device, P, row_bytes, dname):
    """K1 bitwise against its plain version over rank counts, row widths,
    dtypes and window lengths, with starts in range, negative (counted
    once from the end), past the end and far below 0."""
    tdt = DTYPES[dname]
    buf_rows, counts = EXTRACT_ROWS[row_bytes]
    F = row_bytes // torch.tensor([], dtype=tdt).element_size()
    rng = np.random.default_rng(P * row_bytes)
    buf = _data(rng, (P, buf_rows, F), tdt).to(cuda_device)
    ops.reset_launches()
    for rows in counts:
        mixed = rng.integers(-buf_rows, buf_rows + rows, size=P)
        mixed[0] = -3
        for start in (mixed, np.full(P, buf_rows + 7),
                      np.full(P, -2 * buf_rows - 1)):
            st = torch.from_numpy(start.astype(np.int32)).to(cuda_device)
            got = ops.slab_extract(buf, st, rows)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.slab_extract_ref(buf, st, rows)), (
                rows, start)
    assert ops.LAUNCHES["slab_extract"] == 3 * len(counts)


FLASH_CASES = [
    # dtype, B, H, Hkv, T, S, hd, causal, window
    ("bf16", 2, 4, 2, 256, 256, 64, True, None),
    ("bf16", 1, 8, 2, 77, 77, 128, True, None),        # odd T, GQA 4
    ("bf16", 1, 4, 1, 300, 300, 256, True, 100),       # hd 256, window
    ("bf16", 1, 4, 2, 100, 140, 32, False, 30),        # T != S, empty rows
    ("fp32", 2, 4, 2, 256, 256, 64, True, 128),
    ("fp32", 1, 4, 2, 77, 99, 16, True, None),          # odd T and S
    # the Hopper kernel (hd 64, 128, 256; q blocks of 128 rows, kv blocks
    # of 128 keys, 64 at hd 256): GQA groups 1, 4, 8 and 32
    ("bf16", 2, 4, 4, 256, 256, 128, True, None),
    ("bf16", 1, 8, 2, 1000, 1000, 64, True, None),     # T % 128 != 0
    ("bf16", 1, 8, 1, 1000, 1000, 128, True, None),
    ("bf16", 1, 32, 1, 333, 333, 256, True, None),
    ("bf16", 1, 32, 1, 129, 129, 64, True, None),
    ("bf16", 2, 4, 2, 77, 1, 128, False, None),        # one key
    ("bf16", 1, 4, 1, 1, 1000, 256, False, None),      # one query row
    ("bf16", 1, 4, 2, 200, 333, 128, False, None),     # T != S
    ("bf16", 1, 4, 4, 128, 128, 256, False, None),
    ("bf16", 1, 8, 2, 517, 517, 128, True, 45),        # window < kv block
    ("bf16", 2, 10, 1, 600, 600, 256, True, 37),
    ("bf16", 1, 8, 8, 700, 700, 64, True, 200),
    ("bf16", 1, 4, 2, 300, 100, 128, True, 50),        # rows >= 149 see
    ("bf16", 1, 4, 2, 300, 100, 64, True, 50),         # no key
    ("bf16", 1, 4, 1, 300, 100, 256, True, 50),
    # head dim 80 (stablelm-3b) on the mma.sync tile, and in fp32
    ("bf16", 2, 32, 32, 300, 300, 80, True, None),
    ("bf16", 1, 8, 2, 100, 177, 80, False, None),
    ("bf16", 1, 4, 4, 517, 517, 80, True, 45),
    ("fp32", 1, 4, 2, 77, 99, 80, True, None),
    # the VLM's cross-attention: non-causal over 1600 image tokens (12.5
    # kv blocks of 128), prefill T != S and decode T = 1
    ("bf16", 2, 32, 8, 300, 1600, 128, False, None),
    ("bf16", 4, 32, 8, 1, 1600, 128, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    """K8 on the card against its plain version on the same inputs, at the
    JAX package's tolerances (2e-2 in bf16: the probabilities round to
    bf16 for the second product and the output to bf16; 2e-5 in fp32:
    plain FMAs summed in another order); rows with no visible key are 0."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    dname, B, H, Hkv, T, S, hd, causal, window = case
    tdt = DTYPES[dname]
    g = torch.Generator(device=cuda_device).manual_seed(T + hd)
    q = torch.randn((B, H, T, hd), generator=g, device=cuda_device).to(tdt)
    k = torch.randn((B, Hkv, S, hd), generator=g, device=cuda_device).to(tdt)
    v = torch.randn((B, Hkv, S, hd), generator=g, device=cuda_device).to(tdt)
    ops.reset_launches()
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    want = fref.attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dname == "fp32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # a row that sees no key is exactly 0, as in the reference
    seen = fref.visible_mask(T, S, causal=causal, window=window,
                             device=cuda_device).any(-1)
    assert torch.equal(got[:, :, ~seen], torch.zeros_like(got[:, :, ~seen]))
    # the same call on the model's (B, T, H, hd) layout, as strided views
    qt, kt = q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    got_t = fops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                 vt.transpose(1, 2), causal=causal,
                                 window=window)
    assert torch.equal(got_t, got)


@pytest.mark.gpu
def test_cuda_reduced_yi_forward_launches_k8_once_a_layer(cuda_device):
    """A reduced yi-6b on the card: one forward launches K8 once a layer,
    a decode step never, and the logits match the plain versions."""
    import repro_torch as rt
    from repro_torch.models.transformer import Transformer

    cfg = rt.get_config("yi-6b").reduced()
    model = Transformer(cfg, seed=3)
    toks = torch.arange(40, device=cuda_device).reshape(2, 20) % cfg.vocab
    ops.reset_launches()
    cache = model.init_cache(2, 24)
    logits, _, cache = model(toks, cache=cache, logits_last_only=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    ops.reset_launches()
    model.decode(cache, toks[:, :1])
    assert ops.LAUNCHES["flash_attention"] == 0
    try:
        rt.use_kernel_dataplane(False)
        want, _ = model(toks)
    finally:
        rt.use_kernel_dataplane(None)
    torch.testing.assert_close(logits[:, -1], want[:, -1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_reduced_vision_launches_k8_for_self_and_cross(cuda_device):
    """A reduced llama-3.2-vision-11b on the card: a prefill launches K8
    once a layer and once more a cross block, a decode step once a cross
    block (its cross-attention over the image tokens), and the logits
    match the plain versions'."""
    import repro_torch as rt
    from repro_torch.models.transformer import Transformer

    cfg = rt.get_config("llama-3.2-vision-11b").reduced()
    n_cross = cfg.pattern.count("cross") * cfg.n_layers // len(cfg.pattern)
    model = Transformer(cfg, seed=4)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    img = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=g,
                      device=cuda_device)
    toks = torch.arange(40, device=cuda_device).reshape(2, 20) % cfg.vocab
    ops.reset_launches()
    logits, _, cache = model(toks, img=img, cache=model.init_cache(2, 24),
                             logits_last_only=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers + n_cross
    ops.reset_launches()
    model.decode(cache, toks[:, :1], img=img)
    assert ops.LAUNCHES["flash_attention"] == n_cross
    try:
        rt.use_kernel_dataplane(False)
        want, _ = model(toks, img=img)
    finally:
        rt.use_kernel_dataplane(None)
    torch.testing.assert_close(logits[:, -1], want[:, -1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
def test_cuda_model_at_head_dim_80_launches_k8(cuda_device, dname):
    """Reduced stablelm-3b at its published head dim of 80: one prefill
    launches K8 once a layer, and the last logits match the plain
    versions' (relative Frobenius, 1e-4 in fp32, 2e-2 in bf16 as the
    serving checks)."""
    import repro_torch as rt
    from repro_torch.models.transformer import Transformer

    cfg = rt.get_config("stablelm-3b").reduced().with_(
        head_dim=80, dtype={"fp32": "float32", "bf16": "bfloat16"}[dname])
    model = Transformer(cfg, seed=6)
    toks = torch.arange(66, device=cuda_device).reshape(2, 33) % cfg.vocab
    ops.reset_launches()
    logits, _, _ = model(toks, cache=model.init_cache(2, 33),
                         logits_last_only=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    try:
        rt.use_kernel_dataplane(False)
        want, _ = model(toks)
    finally:
        rt.use_kernel_dataplane(None)
    a, b = logits[:, -1].float(), want[:, -1].float()
    rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    assert rel <= (1e-4 if dname == "fp32" else 2e-2), rel


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64])
def test_cuda_flash_attention_takes_more_than_65535_heads(cuda_device, hd):
    """B * H = 65536 (one query row each): K8 puts batch * head and the q
    blocks on one grid axis, so it runs what the reference and the plain
    version compute, where grid y would stop at 65535.  hd 16 runs the
    mma.sync kernel, hd 64 the Hopper one (its tensor maps are 4-d over
    (hd, T, H, B))."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((65536, 1, 1, hd), generator=g,
                           device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    ops.reset_launches()
    got = fops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(),
                               fref.attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


RGLRU_CASES = [
    # B, T, D, random h0 (else 0); D % 4 == 0 takes the single pass (tiles
    # of 256 steps by 32 channels), D % 4 != 0 the two-pass scan
    (4, 2100, 2560, False),     # recurrentgemma-2b's prefill, h0 = 0
    (4, 2100, 2560, True),
    (3, 1000, 2558, True),      # D % 4 != 0: the two-pass path
    (4, 1, 2560, True),         # T = 1
    (1, 64, 8, True),           # one full chunk
    (2, 65, 12, True),          # a chunk and one step
    (2, 63, 256, True),         # the two-pass scan's chunk edges
    (2, 64, 256, True),
    (2, 65, 256, True),
    (2, 255, 256, True),        # one step short of a tile
    (2, 256, 256, True),        # one whole tile a channel group
    (2, 257, 256, True),        # a tile and one step
    (4, 2920, 2560, True),      # recurrentgemma-2b's longest prefill
    (2, 300, 2564, True),       # a last channel group of 4 channels
    (1, 80000, 512, True),      # 313 tiles chained in each channel group
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES,
                         ids=["-".join(map(str, c)) for c in RGLRU_CASES])
def test_cuda_rglru_scan_matches_plain(cuda_device, case):
    """K9 on the card against its plain version on the same inputs, at the
    reference's 1e-5 (the same fp32 multiply-adds; only each chunk's
    carry-in is reassociated), one launch each, on the path its shape
    selects."""
    from repro_torch.kernels.rg_lru import kernel as rkernel
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rg_lru import ref as rref

    B, T, D, random_h0 = case
    g = torch.Generator(device=cuda_device).manual_seed(B * T + D)
    a = torch.rand((B, T, D), generator=g, device=cuda_device)
    b = torch.randn((B, T, D), generator=g, device=cuda_device)
    h0 = (torch.randn((B, D), generator=g, device=cuda_device) if random_h0
          else torch.zeros((B, D), device=cuda_device))
    assert rkernel.single_pass(a, b, h0) == (D % 4 == 0)
    ops.reset_launches()
    h, h_last = rops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == 1
    want, want_last = rref.rglru_scan_ref(a, b, h0)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h_last, want_last, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_rglru_scan_exact_zero_and_one_decays(cuda_device):
    """a exactly 0 (the state forgotten) and exactly 1 (kept whole) on
    some steps, across tile edges and in the first and last tiles, on the
    single pass and the two-pass scan."""
    from repro_torch.kernels.rg_lru import kernel as rkernel
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rg_lru import ref as rref

    for B, T, D in ((3, 700, 384), (2, 300, 258)):
        g = torch.Generator(device=cuda_device).manual_seed(T + D)
        a = torch.rand((B, T, D), generator=g, device=cuda_device)
        pick = torch.rand((B, T, D), generator=g, device=cuda_device)
        a = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, a))
        a[:, 63:66] = 1.0
        a[:, 254:258] = 1.0
        a[:, T - 1] = 0.0
        b = torch.randn((B, T, D), generator=g, device=cuda_device)
        h0 = torch.randn((B, D), generator=g, device=cuda_device)
        assert rkernel.single_pass(a, b, h0) == (D % 4 == 0)
        got = rops.rglru_scan(a, b, h0)
        want = rref.rglru_scan_ref(a, b, h0)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_rglru_scan_twice_reuses_its_workspace(cuda_device):
    """Two calls in a row on different inputs of one shape: the allocator
    hands the second call the first one's workspace, flags and all, and
    both match the plain version (the launcher zeroes the flags)."""
    from repro_torch.kernels.rg_lru import kernel as rkernel
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rg_lru import ref as rref

    B, T, D = 2, 1000, 640
    g = torch.Generator(device=cuda_device).manual_seed(13)
    inputs = [(torch.rand((B, T, D), generator=g, device=cuda_device),
               torch.randn((B, T, D), generator=g, device=cuda_device),
               torch.randn((B, D), generator=g, device=cuda_device))
              for _ in range(2)]
    assert all(rkernel.single_pass(*x) for x in inputs)
    ops.reset_launches()
    got = [rops.rglru_scan(*x) for x in inputs]
    for x, out in zip(inputs, got):
        for y, z in zip(out, rref.rglru_scan_ref(*x)):
            torch.testing.assert_close(y, z, rtol=1e-5, atol=1e-5)
    assert ops.LAUNCHES["rglru_scan"] == 2


@pytest.mark.gpu
def test_cuda_rglru_scan_misaligned_and_empty(cuda_device):
    """Inputs that start 4 bytes past 16-byte alignment take the two-pass
    path; T = 0 launches nothing and returns h0."""
    from repro_torch.kernels.rg_lru import kernel as rkernel
    from repro_torch.kernels.rg_lru import ops as rops
    from repro_torch.kernels.rg_lru import ref as rref

    B, T, D = 2, 300, 64
    g = torch.Generator(device=cuda_device).manual_seed(11)
    buf = torch.rand((2 * B * T * D + 1,), generator=g, device=cuda_device)
    a = buf[1:B * T * D + 1].view(B, T, D)
    b = buf[B * T * D + 1:].view(B, T, D)
    assert a.data_ptr() % 16 and a.is_contiguous()
    h0 = torch.randn((B, D), generator=g, device=cuda_device)
    assert not rkernel.single_pass(a, b, h0)
    got = rops.rglru_scan(a, b, h0)
    want = rref.rglru_scan_ref(a, b, h0)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    ops.reset_launches()
    h, h_last = rops.rglru_scan(a[:, :0], b[:, :0], h0)
    assert h.shape == (B, 0, D) and torch.equal(h_last, h0)
    assert ops.LAUNCHES["rglru_scan"] == 0


@pytest.mark.gpu
def test_cuda_reduced_recurrentgemma_launches_k9_and_k8(cuda_device):
    """A reduced recurrentgemma-2b on the card (6 layers: 4 RG-LRU, 2
    local, window 16, prompts of 40): one prefill launches K9 once an
    RG-LRU block and K8 once a local block, a decode step neither, and
    the logits match the plain versions."""
    import repro_torch as rt
    from repro_torch.models.transformer import Transformer

    cfg = rt.get_config("recurrentgemma-2b").reduced()
    model = Transformer(cfg, seed=3)
    toks = torch.arange(80, device=cuda_device).reshape(2, 40) % cfg.vocab
    ops.reset_launches()
    cache = model.init_cache(2, 44)
    logits, _, cache = model(toks, cache=cache, logits_last_only=True)
    assert ops.LAUNCHES["rglru_scan"] == 4
    assert ops.LAUNCHES["flash_attention"] == 2
    ops.reset_launches()
    model.decode(cache, toks[:, :1])
    assert ops.LAUNCHES["rglru_scan"] == ops.LAUNCHES["flash_attention"] == 0
    try:
        rt.use_kernel_dataplane(False)
        want, _ = model(toks)
    finally:
        rt.use_kernel_dataplane(None)
    torch.testing.assert_close(logits[:, -1], want[:, -1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_k6_and_k9_refuse_autograd(cuda_device):
    """On the card, a K6 or K9 call that autograd would record raises
    (the extensions' outputs carry no ``grad_fn``) and launches nothing;
    under ``no_grad`` the kernels launch."""
    from repro_torch.kernels.rg_lru import ops as rops

    x = torch.randn(6, 4, device=cuda_device, requires_grad=True)
    idx = torch.tensor([5, 0, 2], dtype=torch.int32, device=cuda_device)
    a = torch.rand(2, 5, 4, device=cuda_device)
    b = torch.randn(2, 5, 4, device=cuda_device, requires_grad=True)
    h0 = torch.zeros(2, 4, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="item D2"):
        ops.ragged_gather(x, idx)
    with pytest.raises(NotImplementedError, match="item D2"):
        rops.rglru_scan(a, b, h0)
    assert ops.LAUNCHES["ragged_gather"] == ops.LAUNCHES["rglru_scan"] == 0
    with torch.no_grad():
        assert torch.equal(ops.ragged_gather(x, idx), x[[5, 0, 2]])
        rops.rglru_scan(a, b, h0)
    assert ops.LAUNCHES["ragged_gather"] >= 1
    assert ops.LAUNCHES["rglru_scan"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,T", [("mixtral-8x7b", 24),
                                    ("recurrentgemma-2b", 768)])
def test_cuda_gradients_through_moe_and_rglru_match_the_cpu(cuda_device,
                                                           arch, T):
    """The loss and every gradient of reduced mixtral-8x7b (the MoE layer)
    and recurrentgemma-2b (the RG-LRU scan, chunked at T=768) on the card
    within 1e-5 / 1e-4 (relative Frobenius) of the CPU's, which
    ``tests/test_torch_train.py`` holds to the JAX package's; TF32 off.
    No K6, K8 or K9 launch under autograd."""
    import repro_torch as rt
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = rt.get_config(arch).reduced()
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg,
                           AdamWConfig(), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}

    def grads(params, device):
        leaves = [p.detach().to(device).requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), cfg,
                          {k: v.to(device) for k, v in batch.items()})
        return loss, torch.autograd.grad(loss, leaves)
    want_loss, want = grads(cpu.params, "cpu")
    ops.reset_launches()
    loss, got = grads(cpu.params, cuda_device)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(got, want):
        err = torch.linalg.vector_norm(g.cpu() - w) / torch.clamp_min(
            torch.linalg.vector_norm(w), 1e-30)
        assert float(err) <= 1e-4
