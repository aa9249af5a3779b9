"""The port's stream backend (kgcn_tpu_torch/ops/stream_spmm.py, the stream
branches of ops/spmm.py) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
stream kernels run in Pallas interpret mode with the tiny parameters of
tests/test_stream_spmm.py; the port runs its plain versions (the CUDA
kernels' CPU path).  Tolerances: structures equal array for array; the
float32 payload rtol = atol = 1e-5 (summation order only); the bf16 payload
atol 1e-4 × max|reference| (both packages round the same operands to bf16,
the products are exact in f32, only the order of the f32 sums differs).
No JAX process global is flipped: the compute dtype is passed per call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu.ops import stream_spmm as js
from kgcn_tpu_torch.ops import stream_spmm as ts

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("slot_sender", "r_loc", "slot_src", "sub_wid", "macro_rb",
          "macro_first", "t_from_f", "w_slots", "oh")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (name, receivers V, senders Vs, edges E, F, build kwargs): the JAX suite's
# parameter sets and the structure's trouble spots
CASES = [
    ("square", 100, 100, 400, 16, dict(tr_w=16, chunk=8, mc=4, wb=2)),
    ("odd", 37, 37, 150, 5, dict(tr_w=8, chunk=8, mc=2, wb=4)),
    ("wide", 300, 300, 900, 33, dict(tr_w=32, chunk=16, mc=8, wb=8)),
    ("rectangular", 40, 90, 300, 12, dict(tr_w=8, chunk=8, mc=2, wb=2)),
    ("budget", 64, 64, 256, 12, dict(tr_w=16, chunk=8, mc=4, wb=2, macro_budget=40)),
    ("no_onehots", 64, 64, 256, 12, dict(tr_w=16, chunk=8, mc=4, wb=2,
                                          materialize=False)),
]
NAMES = [c[0] for c in CASES]


def _case(name, zero_every=4):
    _, V, Vs, E, F, kw = next(c for c in CASES if c[0] == name)
    rng = np.random.RandomState(V + E)
    s = rng.randint(0, Vs, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    w = rng.standard_normal(E).astype(np.float32)
    w[::zero_every] = 0.0  # padding edges, dropped from the structure
    if Vs != V:
        kw = dict(kw, num_sender_nodes=Vs)
    return V, Vs, F, s, r, w, kw


def _both(name, **over):
    V, Vs, F, s, r, w, kw = _case(name)
    kw = dict(kw, **over)
    return (V, Vs, F, s, r, w, js.build_stream(s, r, V, weights=w, **kw),
            ts.build_stream(s, r, V, weights=w, **kw))


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def assert_same_structure(je, te):
    assert dataclasses.asdict(je.meta) == dataclasses.asdict(te.meta)
    for name in FIELDS:
        a, b = getattr(je, name), getattr(te, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if name == "oh":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(a), b.to(torch.float32).numpy(), err_msg=name)
        else:
            assert b.dtype == (torch.float32 if name == "w_slots" else torch.int32), name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert (je.transpose is None) == (te.transpose is None)
    if je.transpose is not None:
        assert_same_structure(je.transpose, te.transpose)


@pytest.mark.parametrize("name", NAMES)
def test_build_stream_matches_jax(name):
    *_, je, te = _both(name)
    assert_same_structure(je, te)


@pytest.mark.parametrize("name", NAMES)
def test_window_ranges_cover_every_real_slot_once(name):
    """Each receiver window's sub-chunks, found through macro_rb / sub_wid
    (block·wb + window), start with a run of consecutive ones that holds
    exactly the slots of the edges into that window, padded to whole
    sub-chunks (at least one); together the runs hold every real slot once,
    and every other sub-chunk holds padding alone."""
    V, Vs, F, s, r, w, kw = _case(name)
    te = ts.build_stream(s, r, V, weights=w, **kw)
    valid = np.nonzero(w != 0)[0]
    for ss, recv in ((te, r), (te.transpose, s)):
        m = ss.meta
        subs = np.arange(ss.sub_wid.shape[0])
        win = ss.macro_rb.numpy()[subs // m.mc] * m.wb + ss.sub_wid.numpy()[:, 0]
        src = ss.slot_src.numpy().reshape(-1, m.chunk)
        real = src < m.num_edges
        n_win = -(-m.num_receivers // m.tr_w)
        edges_in = np.bincount(recv[valid] // m.tr_w, minlength=n_win)
        seen = np.zeros(real.shape, bool)
        for wi in range(n_win):
            first = np.nonzero(win == wi)[0][0]
            run = np.arange(first, first + max(-(-edges_in[wi] // m.chunk), 1))
            np.testing.assert_array_equal(win[run], wi)
            np.testing.assert_array_equal(
                np.sort(src[run][real[run]]),
                np.sort(valid[recv[valid] // m.tr_w == wi]))
            assert not seen[run].any()
            seen[run] = True
        assert not (real & ~seen).any()


def _port_structure(name):
    """The port's structure of a case, or of the hub case: 2 000 receivers,
    4 000 uniform edges and 3 000 more into receiver 7."""
    if name != "hub":
        return _both(name)[-1]
    rng = np.random.RandomState(7)
    V, E, H = 2000, 4000, 3000
    s = rng.randint(0, V, E + H)
    r = np.concatenate([rng.randint(0, V, E), np.full(H, 7)])
    w = rng.standard_normal(E + H).astype(np.float32)
    return ts.build_stream(s, r, V, weights=w, tr_w=16, chunk=8, mc=4, wb=2)


PLAN_NAMES = NAMES + ["hub"]
# csrc/stream.cu: a split row of at most this many partials is summed by one
# warp in piece order
SPLIT_WARP = 64


def _piece_rows(plan):
    """(piece of each entry, first and last row of each piece)."""
    slot, row, _ = plan.entries.numpy().astype(np.int64)
    n, P = len(row), plan.piece
    piece = np.arange(n) // P
    starts = np.arange(plan.pieces.shape[0]) * P
    return piece, row[starts], row[np.minimum(starts + P, n) - 1]


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_plan_covers_every_real_slot_once(name):
    """The scatter kernels' plan (the port's addition): every real slot once,
    in slot order, no padding or filler slot, pieces of at most ``piece``
    slots, and split rows with consecutive partials in piece order."""
    te = _port_structure(name)
    for ss in (te, te.transpose):
        m, plan = ss.meta, ss.plan
        valid, send, recv = ts._slot_rows(ss)
        slot, row, sender = plan.entries.numpy().astype(np.int64)
        np.testing.assert_array_equal(slot, np.nonzero(valid.numpy())[0])
        np.testing.assert_array_equal(row, recv.numpy()[slot])
        np.testing.assert_array_equal(sender, send.numpy()[slot])
        assert (sender < m.num_senders).all() and (np.diff(row) >= 0).all()
        n, P = len(slot), plan.piece
        assert P == ts._piece_size(n) and P % 32 == 0
        assert plan.pieces.shape == (-(-n // P), 4)
        piece, first, last = _piece_rows(plan)
        info = plan.pieces.numpy()
        # split rows: exactly those whose slots lie in more than one piece
        rows_u, n_pieces = np.unique(np.unique(np.stack([row, piece]), axis=1)[0],
                                     return_counts=True)
        splits = plan.splits.numpy()
        np.testing.assert_array_equal(splits[:, 0], rows_u[n_pieces > 1])
        used = []
        for k, (r, off, count, blocks) in enumerate(splits):
            ps = np.unique(piece[row == r])
            assert count == len(ps) and blocks == len(np.unique(ps // ts.PIECES_PER_BLOCK))
            which = np.where(first[ps] == r, 0, 2)
            np.testing.assert_array_equal(info[ps, which], k)
            np.testing.assert_array_equal(info[ps, which + 1], np.arange(off, off + count))
            used.extend(info[ps, which + 1])
        assert sorted(used) == list(range(plan.n_parts))
        # whole rows name no partial; a one-row piece uses its first slot only
        assert (info[~np.isin(first, splits[:, 0]), :2] == -1).all()
        assert (info[~np.isin(last, splits[:, 0]) | (last == first), 2:] == -1).all()
        filled = np.zeros(m.num_receivers, bool)
        filled[row] = True
        np.testing.assert_array_equal(plan.empty_rows.numpy(), np.nonzero(~filled)[0])
        assert plan.arrivals.shape == (len(splits),) and not plan.arrivals.any()


def test_piece_size():
    assert [ts._piece_size(n) for n in (0, 41_103, 110_359, 10**6, 10**8)] == [
        32, 32, 64, 512, 512]


def _in_order(rows):
    """Σ rows, added one after another from 0 (f32)."""
    total = torch.zeros_like(rows[0]) if len(rows) else 0.0
    for row in rows:
        total = total + row
    return total


def _emulate_plan(ss, w_slots, x, mode):
    """The scatter kernel's arithmetic in its order, in PyTorch: each piece
    sums its rows from 0 in slot order, whole rows go to the output and the
    pieces' first and last rows to partials, a split row is the sum of its
    partials (in order where there are at most ``SPLIT_WARP``, else 8
    consecutive runs in order, then the 8 in order), and rows without a
    slot are zeros.  Checks that every row is written once."""
    m, plan = ss.meta, ss.plan
    slot, row, send = plan.entries.long()
    x = x.to(torch.float32)
    if mode == "onehot":
        w, xs = ss.oh[slot, row % m.tr_w].to(torch.float32), ts._rb(x[send])
    else:
        w, xs = w_slots[slot], x[send]
        if mode == "bfloat16":
            w, xs = ts._rb(w), ts._rb(xs)
    msg = w[:, None] * xs
    piece, first, last = (torch.from_numpy(a) for a in _piece_rows(plan))
    info = plan.pieces.long()
    c = torch.where(row == first[piece], info[piece, 1],
                    torch.where(row == last[piece], info[piece, 3], -1))
    direct = c < 0
    out = torch.zeros((m.num_receivers, x.shape[1]))
    out.index_add_(0, row[direct], msg[direct])
    part = torch.zeros((plan.n_parts, x.shape[1]))
    part.index_add_(0, c[~direct], msg[~direct])
    written = torch.zeros(m.num_receivers, dtype=torch.long)
    # a whole row lies in one piece
    pairs = torch.unique(torch.stack([row[direct], piece[direct]]), dim=1)
    written.index_add_(0, pairs[0], torch.ones_like(pairs[0]))
    W = ts.PIECES_PER_BLOCK
    for r, off, count, _ in plan.splits.long().tolist():
        per = count if count <= SPLIT_WARP else -(-count // W)
        runs = [_in_order(part[off + min(i * per, count): off + min((i + 1) * per, count)])
                for i in range(W)]
        out[r] = _in_order(runs)
        written[r] += 1
    written[plan.empty_rows.long()] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PLAN_NAMES)
def test_plan_emulation_matches_reference(name, dtype):
    """The plan's order of sums gives the plain versions' values, both
    directions (only the order of the f32 sums differs)."""
    te = _port_structure(name)
    for i, ss in enumerate((te, te.transpose)):
        m = ss.meta
        x = torch.from_numpy(_x(m.num_senders, 24, seed=20 + i))
        w = torch.from_numpy(np.random.RandomState(30 + i).standard_normal(
            m.slots).astype(np.float32))
        np.testing.assert_allclose(
            _emulate_plan(ss, w, x, dtype).numpy(),
            ts.stream_scatter_reference(ss, w, x, dtype).numpy(), **F32)
        if dtype == "bfloat16" and ss.oh is not None:
            np.testing.assert_allclose(
                _emulate_plan(ss, None, x, "onehot").numpy(),
                ts.stream_scatter_mat_reference(ss, ss.oh, x).numpy(), **F32)


# csrc/stream.cu: entries a weight-gradient lane group keeps in flight
DW_BATCH = 8


def _dw_layout(F):
    """(LPR, CONTIG) of the weight-gradient kernel at width F: 4 columns a
    lane, consecutive where F % 4 == 0 (the operands on the card being
    16-byte aligned), else strided by LPR; LPR lanes a group (4-32, the
    fewest that cover F)."""
    lanes = -(-F // 4)
    return next(n for n in (4, 8, 16, 32) if lanes <= n or n == 32), F % 4 == 0


def _emulate_dw(ss, x, dy, dtype):
    """The weight-gradient kernel's walk in PyTorch: the plan's entries in
    spans of ``_dw_span``, each lane group's run of one receiver reading dy
    once (at most ``DW_BATCH`` entries a group at a time; a warp holds it
    across its span where it is one group in one pass) — the dy each entry
    multiplies is the one its run's first entry read; per entry each lane
    sums its columns' products from 0 in order, then the group's lanes in a
    butterfly at strides LPR/2 … 1; the padding slots between an entry and
    the one before it, and after the last one (spread over the grid's
    warps), written as zeros.  Checks that every slot is written once.
    Returns (out, dy row reads)."""
    m, plan = ss.meta, ss.plan
    slot, row, send = plan.entries.long()
    n = len(slot)
    F = x.shape[1]
    span = ts._dw_span(plan, F)
    lpr, contig = _dw_layout(F)
    sub = min(lpr, DW_BATCH)
    passes = max(1, -(-F // (lpr * 4)))
    carry = lpr == 32 and passes == 1
    assert span % sub == 0
    e = torch.arange(n)
    # where the held dy ends: a span's start, else every sub-batch of a group
    start = (e % span == 0) if carry else (e % span % sub == 0)
    fresh = start | torch.cat([torch.ones(min(n, 1), dtype=torch.bool), row[1:] != row[:-1]])
    loader = torch.cummax(torch.where(fresh, e, -1), 0).values
    assert (row[loader] == row).all()
    xs, dr = x.to(torch.float32)[send], dy.to(torch.float32)[row[loader]]
    if dtype == "bfloat16":
        xs, dr = ts._rb(xs), ts._rb(dr)
    prod = torch.zeros((n, passes * lpr * 4))
    prod[:, :F] = xs * dr
    # [entry, pass, lane, column of the lane] -> each lane's columns in order
    if contig:
        lanes = prod.reshape(n, passes, lpr, 4).permute(0, 2, 1, 3)
    else:
        lanes = prod.reshape(n, passes, 4, lpr).permute(0, 3, 1, 2)
    lanes = lanes.reshape(n, lpr, passes * 4)
    acc = torch.zeros((n, lpr))
    for k in range(lanes.shape[2]):
        acc = acc + lanes[:, :, k]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    out = torch.full((m.slots,), float("nan"))
    out[slot] = acc[:, 0]
    written = torch.zeros(m.slots + 1, dtype=torch.long)
    written.index_add_(0, slot, torch.ones_like(slot))
    # each entry's gap (prev + 1 .. slot) and the tail, as +1/-1 at the ends
    lo = torch.cat([torch.tensor([-1]), slot]) + 1
    hi = torch.cat([slot, torch.tensor([m.slots])])
    cover = torch.zeros(m.slots + 1, dtype=torch.long)
    cover.index_add_(0, lo, torch.ones_like(lo)).index_add_(0, hi, -torch.ones_like(hi))
    gap = torch.cumsum(cover, 0)[:m.slots]
    out[gap > 0] = 0.0
    assert ((written[:m.slots] + gap) == 1).all()
    return out, int(fresh.sum()) * passes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PLAN_NAMES)
def test_dw_emulation_matches_reference(name, dtype):
    """The weight-gradient kernel's walk gives the plain version's values in
    both directions, at the structure's width and at 27, 64, 128, 133 and
    200 — every lane layout: 4 consecutive columns a lane in groups of 4
    (F 12, 16), 8 (hub F 24), 16 (64) and 32 (128, 200 in two passes), and
    4 strided in groups of 4 (``odd`` F 5), 8 (27), 16 (``wide`` F 33) and 32
    (133) — with the padding slots exactly 0 (float32 rtol = atol = 1e-5:
    only the order of the f32 sums differs; bf16 the same, its products
    being exact), and reads dy once per run of a receiver within a lane
    group's stretch."""
    te = _port_structure(name)
    F0 = 24 if name == "hub" else next(c[4] for c in CASES if c[0] == name)
    for i, ss in enumerate((te, te.transpose)):
        m = ss.meta
        valid = (ss.slot_sender < m.num_senders).numpy()
        for F in (F0, 27, 64, 128, 133, 200):
            x = torch.from_numpy(_x(m.num_senders, F, seed=40 + i))
            dy = torch.from_numpy(_x(m.num_receivers, F, seed=50 + i))
            got, reads = _emulate_dw(ss, x, dy, dtype)
            np.testing.assert_allclose(
                got.numpy(), ts.stream_dw_reference(ss, x, dy, dtype).numpy(), **F32)
            assert not got[~valid].any()
            rows = ss.plan.entries[1].long()
            lpr, _ = _dw_layout(F)
            assert reads <= len(rows) * -(-F // (lpr * 4))
            if F == 128:  # one pass: a run of one row within a span reads dy once
                span = torch.arange(len(rows)) // ts._dw_span(ss.plan, F)
                assert reads == len(torch.unique(torch.stack([span, rows]), dim=1).T)


@pytest.mark.parametrize("n_real, F, want", [
    (41_103, 128, 24),      # the KG's smallest channel: 1 285 pieces of 32
    (110_359, 128, 56),     # its largest: 1 725 pieces of 64
    (9_600, 133, 8),        # 300 pieces of 32
    (41_103, 64, 32),       # two lane groups a warp: the plan's piece
    (1_000_000, 128, 496),  # 1 954 pieces of 512
    (2_000_000, 128, 512),  # enough pieces
    (0, 128, 8),
])
def test_dw_span_fills_small_structures(n_real, F, want):
    """The weight-gradient kernel's span: the plan's piece, shortened where
    F > 64 and the plan has fewer pieces than ``_TARGET_PIECES``, to a
    multiple of 8 that gives about that many warps."""
    plan = ts.StreamPlan(piece=ts._piece_size(n_real),
                         entries=torch.zeros((3, n_real), dtype=torch.int32),
                         pieces=None, splits=None, empty_rows=None, arrivals=None,
                         n_parts=0)
    span = ts._dw_span(plan, F)
    assert span == want and span % 8 == 0 and span <= plan.piece
    if span < plan.piece:
        assert -(-n_real // span) <= ts._TARGET_PIECES


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_onehot_rows_hold_one_entry_at_r_loc(name):
    """The one-hot kernel reads ``oh[slot, r_loc[slot]]`` alone:
    ``_materialize_oh`` puts a row's only non-zero there (padding rows are
    all zero)."""
    te = _port_structure(name)
    for ss in (te, te.transpose):
        if ss.oh is None:
            continue
        oh = ss.oh.to(torch.float32)
        r_loc = ss.r_loc.reshape(-1).long()
        at = oh[torch.arange(oh.shape[0]), r_loc]
        oh[torch.arange(oh.shape[0]), r_loc] = 0
        assert not oh.any()
        real = ss.slot_sender < ss.meta.num_senders
        np.testing.assert_array_equal(at[real].numpy(), ts._rb(ss.w_slots[real]).numpy())
        assert not at[~real].any()


def test_build_stream_valid_mask_keeps_zero_weight_edges():
    V, Vs, F, s, r, w, kw = _case("square", zero_every=3)
    valid = np.ones_like(w)
    valid[1::5] = 0.0
    je = js.build_stream(s, r, V, weights=w, valid_mask=valid, **kw)
    te = ts.build_stream(s, r, V, weights=w, valid_mask=valid, **kw)
    assert_same_structure(je, te)
    kept = set(te.slot_src.numpy().tolist()) - {len(w)}
    assert kept == set(np.nonzero(valid)[0].tolist())


def test_macro_budget_too_small_raises():
    V, Vs, F, s, r, w, kw = _case("square")
    with pytest.raises(ValueError, match="macro budget"):
        ts.build_stream(s, r, V, weights=w, **dict(kw, macro_budget=1))


def _x(rows, F, seed=0):
    return np.random.RandomState(seed).standard_normal((rows, F)).astype(np.float32)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_stream_spmm_baked_matches_jax(name, dtype):
    """Baked weights: the static route (bf16 with one-hots) or the iota
    route, as the JAX package picks."""
    V, Vs, F, *_, je, te = _both(name)
    x = _x(Vs, F)
    want = js.stream_spmm(je, x=jnp.asarray(x), compute_dtype=JDT[dtype])
    got = ts.stream_spmm(te, x=torch.from_numpy(x), compute_dtype=dtype)
    assert tuple(got.shape) == (V, F)
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["square", "rectangular", "budget", "odd", "wide"])
def test_stream_spmm_gradients_match_jax_grad(name, dtype):
    """Dynamic edge-order weights (``stream_spmm_edges``): value, dx through
    the transpose structure and d(weights) through the weight-gradient
    kernel's plain version, against ``jax.grad`` (``odd`` and ``wide``: F 5
    and 33, the kernel's small lane groups and strided columns)."""
    V, Vs, F, s, r, w, je, te = _both(name)
    x = _x(Vs, F, seed=1)
    cot = _x(V, F, seed=2)
    w2 = np.random.RandomState(3).standard_normal(len(w)).astype(np.float32)

    def jloss(wv, xv):
        out = js.stream_spmm_edges(je, wv, xv, compute_dtype=JDT[dtype])
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, jout), (jdw, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(w2), jnp.asarray(x))
    tw = torch.from_numpy(w2).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = ts.stream_spmm_edges(te, tw, tx, compute_dtype=dtype)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout.detach().numpy(), jout, dtype)
    _close(tx.grad.numpy(), jdx, dtype)
    _close(tw.grad.numpy(), jdw, dtype)


@pytest.mark.parametrize("name", ["square", "rectangular", "odd"])
def test_static_route_dx_matches_jax_grad(name):
    """The static route's backward (the one-hot kernel on the transpose
    one-hots), bf16 payload."""
    V, Vs, F, *_, je, te = _both(name)
    x = _x(Vs, F, seed=4)
    cot = _x(V, F, seed=5)
    jdx = jax.grad(lambda xv: jnp.sum(js.stream_spmm(je, x=xv, compute_dtype=jnp.bfloat16)
                                      * jnp.asarray(cot)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (ts.stream_spmm(te, x=tx, compute_dtype="bfloat16")
     * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad.numpy(), jdx, "bfloat16")


def test_slot_weights_and_transpose_alignment_match_jax():
    V, Vs, F, s, r, w, je, te = _both("square")
    ws = js.edge_to_slot(je, w)
    np.testing.assert_array_equal(ts.edge_to_slot(te, w), ws)
    np.testing.assert_array_equal(
        ts.transpose_w_slots(te, torch.from_numpy(ws)).numpy(),
        np.asarray(js.transpose_w_slots(je, jnp.asarray(ws))))
    x = _x(Vs, F, seed=6)
    for dtype in ("float32", "bfloat16"):
        want = js.stream_spmm(je, jnp.asarray(ws), jnp.asarray(x), compute_dtype=JDT[dtype])
        got = ts.stream_spmm(te, torch.from_numpy(ws), torch.from_numpy(x),
                             compute_dtype=dtype)
        _close(got.numpy(), want, dtype)


def test_bake_stream_is_the_static_route():
    V, Vs, F, *_, je, te = _both("square")
    x = _x(Vs, F, seed=7)
    want = js.stream_spmm_baked(js.bake_stream(je), jnp.asarray(x))
    got = ts.stream_spmm_baked(ts.bake_stream(te), torch.from_numpy(x))
    _close(got.numpy(), want, "bfloat16")
    with pytest.raises(ValueError, match="one-hots"):
        ts.bake_stream(_both("no_onehots")[-1])


def test_choose_stream_matches_jax():
    assert ts.choose_stream(None, None, 100_000, 128) == js.choose_stream(
        None, None, 100_000, 128)


def _coo_oracle(s, r, w, x, V, bf16):
    """``out[r] = Σ w·x[s]`` straight from the edge list, float64."""
    xs = x[s].astype(np.float64)
    wv = w.astype(np.float64)
    if bf16:
        xs = torch.from_numpy(x[s]).to(torch.bfloat16).double().numpy()
        wv = torch.from_numpy(w).to(torch.bfloat16).double().numpy()
    out = np.zeros((V, x.shape[1]))
    np.add.at(out, r, wv[:, None] * xs)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_against_the_coo_oracle(dtype):
    bf16 = dtype == "bfloat16"
    V, Vs, F, s, r, w, kw = _case("rectangular")
    te = ts.build_stream(s, r, V, weights=w, **kw)
    x = _x(Vs, F, seed=8)
    g = _x(V, F, seed=9)
    want = _coo_oracle(s, r, w, x, V, bf16)
    got = ts.stream_scatter_reference(te, te.w_slots, torch.from_numpy(x), dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if bf16:
        got = ts.stream_scatter_mat_reference(te, te.oh, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # transpose: the adjoint
    want_t = _coo_oracle(r, s, w, g, Vs, bf16)
    got_t = ts.stream_scatter_reference(te.transpose, te.transpose.w_slots,
                                        torch.from_numpy(g), dtype)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-5, atol=1e-5)
    # weight gradient: per edge <g[r], x[s]>, read back in slot order
    dw = ts.stream_dw_reference(te, torch.from_numpy(x), torch.from_numpy(g), dtype).numpy()
    xs, gr = x[s].astype(np.float64), g[r].astype(np.float64)
    if bf16:
        xs = torch.from_numpy(x[s]).to(torch.bfloat16).double().numpy()
        gr = torch.from_numpy(g[r]).to(torch.bfloat16).double().numpy()
    per_edge = (xs * gr).sum(axis=1)
    src = te.slot_src.numpy()
    real = src < len(w)
    np.testing.assert_allclose(dw[real], per_edge[src[real]], rtol=1e-5, atol=1e-5)
    assert not dw[~real].any()


def test_cpu_tensors_launch_no_kernel():
    V, Vs, F, *_, te = _both("square")
    before = (ts.stream_scatter.launches, ts.stream_scatter_mat.launches,
              ts.stream_dw.launches)
    w = torch.ones(400, requires_grad=True)
    x = torch.from_numpy(_x(Vs, F)).requires_grad_(True)
    ts.stream_spmm(te, x=x).sum().backward()
    ts.stream_spmm_edges(te, w, x, compute_dtype="float32").sum().backward()
    assert (ts.stream_scatter.launches, ts.stream_scatter_mat.launches,
            ts.stream_dw.launches) == before


def test_stream_spmm_rejects_bad_operands():
    V, Vs, F, s, r, w, kw = _case("square")
    te = ts.build_stream(s, r, V, weights=w, **kw)
    with pytest.raises(ValueError, match="num_senders"):
        ts.stream_spmm(te, x=torch.zeros(V + 1, F))
    with pytest.raises(ValueError, match="with_transpose"):
        ts.stream_spmm(ts.build_stream(s, r, V, weights=w, with_transpose=False, **kw),
                       x=torch.zeros(Vs, F))
    with pytest.raises(ValueError, match="no weights"):
        ts.stream_spmm(ts.build_stream(s, r, V, **kw), x=torch.zeros(Vs, F))
    with pytest.raises(ValueError, match="compute dtype"):
        ts.stream_spmm(te, x=torch.zeros(Vs, F), compute_dtype="float16")
    with pytest.raises(ValueError, match="multiples of 8"):
        ts.build_stream(s, r, V, tr_w=12)


def test_spmm_multichannel_stream_matches_jax():
    """The channel loop of ``spmm_multichannel`` on stream structures:
    baked weights (None) and given weights, shared and per-channel x."""
    from kgcn_tpu.ops.spmm import spmm_multichannel as j_mc
    from kgcn_tpu_torch.ops.spmm import spmm_multichannel as t_mc

    rng = np.random.RandomState(11)
    C, V, E, F = 2, 48, 200, 6
    s = rng.randint(0, V, (C, E)).astype(np.int32)
    r = rng.randint(0, V, (C, E)).astype(np.int32)
    w = rng.random_sample((C, E)).astype(np.float32)
    kw = dict(tr_w=8, chunk=8, mc=2, wb=2)
    jst = tuple(js.build_stream(s[c], r[c], V, weights=w[c], **kw) for c in range(C))
    tst = tuple(ts.build_stream(s[c], r[c], V, weights=w[c], **kw) for c in range(C))
    for x in (_x(V, F, seed=12), np.stack([_x(V, F, seed=13), _x(V, F, seed=14)])):
        for weights in (None, w):
            want = j_mc(jnp.asarray(s), jnp.asarray(r),
                        None if weights is None else jnp.asarray(weights),
                        jnp.asarray(x), V, backend="stream", stream=jst)
            got = t_mc(torch.from_numpy(s), torch.from_numpy(r),
                       None if weights is None else torch.from_numpy(weights),
                       torch.from_numpy(x), V, backend="stream", stream=tst,
                       compute_dtype="bfloat16")
            # JAX's global payload default is bf16 too
            _close(got.numpy(), want, "bfloat16")
    with pytest.raises(ValueError, match="no weights given or baked in"):
        t_mc(torch.from_numpy(s), torch.from_numpy(r), None, torch.from_numpy(x), V,
             backend="stream", stream=tuple(ts.build_stream(s[c], r[c], V, **kw)
                                            for c in range(C)))
