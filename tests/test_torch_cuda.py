"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card (decided in
the ``cuda`` fixture, while the test runs).  The file imports no JAX, so
it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

`lsh_retrieve` must equal its plain version bit for bit, at every pool
width the wrapper takes; the fused
scorer `score_topn` within rtol/atol 1e-5 with equal items wherever
neighbouring top-N scores differ by more than 1e-5 (summation order);
the fused in-place steps, CULSH-MF (`culsh_sgd_batch`, `culsh_sgd_tier`)
and CUSGD++ (`mf_sgd_batch`, `mf_sgd_tier`), against the plain gather →
step → delta scatter on copies of the planes, within rtol 1e-5 /
atol 1e-6 (the JAX package's kernel tolerance, `tests/test_kernels.py`),
with the rows of invalid slots bit for bit unchanged; `simlsh_encode` within rtol/atol 1e-5, and bit
for bit with Φ = ±1 (the kernel and its plain version both sum over d in
order, and every product is exact); `neighbor_predict` within rtol/atol
1e-4.  The multi-device tiers run on four logical shards of the card
(``REPRO_TORCH_LOGICAL_DEVICES=4``): the sharded flush equal to the CPU's
and launching neither serving kernel, its truncation-free answers equal
to the one-device plain walk's, and the fit's mesh shard tier within
1e-5 of its one-device replay.  The LM side (no kernel of its own):
the dense, ssm, hybrid and moe families' forward, decode caches and
train steps, and the encdec and vlm families' forward, prefill, decode
caches and train steps, on the card against the CPU at float32; the
card's parameter draws equal to the CPU's beside meta trees of the same
shapes; with bfloat16 parameters the card's draws bit for bit the CPU's, `logits_of`
without a float32 copy of its output table, and reduced llama3-405b and
arctic-480b's greedy tokens equal to the CPU's; with bfloat16
parameters, gradient sum and moments their µ = 2 step equal to the
CPU's, and a step whose memory rises by one table's gradient, not one a
block.  The LM mesh on eight logical cells of the card: a one-layer
moe cut's prefill, decode and train step equal to the CPU's on the same
2 × 4 mesh (routes, kept slots, values; a2a and ep2d), and `moe_ffn` /
`moe_ffn_ep2d` forward and backward bit-equal over two runs, the
combine through `segment_add`.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.core import model, sgd, simlsh
from repro_torch.data import sparse, synthetic
from repro_torch.data.sparse import from_coo, train_test_split
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.candidate_score.ref import (NEG, assert_topn_close,
                                                    score_topn_ref)
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref
from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
from repro_torch.kernels.mf_sgd.ops import culsh_hyper, mf_hyper
from repro_torch.kernels.mf_sgd.ref import (apply_culsh_sgd_ref,
                                            apply_mf_sgd_ref)
from repro_torch.kernels.neighbor_predict import kernel as np_kernel
from repro_torch.kernels.neighbor_predict.ops import predict_batch
from repro_torch.kernels.neighbor_predict.ref import neighbor_predict_ref
from repro_torch.kernels.simlsh_encode import kernel as se_kernel
from repro_torch.kernels.simlsh_encode.ops import encode_band
from repro_torch.kernels.simlsh_encode.ref import simlsh_encode_ref
from repro_torch.kernels.lsh_retrieve.ops import retrieve_candidates
from repro_torch.serve import (RecsysService, ServeConfig, build_index,
                               full_topn, insert, padded_flat_ids,
                               recommend_walked_kernel, seed_items,
                               tail_hits, window_slices)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import make_catalog  # noqa: E402  (the smoke's catalog)

SENTINEL = 2 ** 31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided while the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(N=1500, seed=0):
    """A small planted catalog (`chip_smoke.make_catalog` at F = 16),
    encoded and indexed by the port on the CPU."""
    U, V, bh, rows, cols, vals, M = make_catalog(N, "cpu", seed=seed, F=16)
    z = np.zeros((N, 1))
    params = convert.params_from_numpy(U, V, np.zeros(M), bh, z, z, 3.0,
                                       device="cpu")
    sp = from_coo(rows, cols, vals, (M, N), device="cpu")
    sigs = simlsh.encode(sp, simlsh.SimLSHConfig(G=8, p=2, q=10),
                         prng.PRNGKey(seed))
    return params, sp, sigs, build_index(sigs, tail_cap=32, device="cpu")


def _flush_args(B, C, F, N, rng, pad_p=0.3, M=50):
    """Operands of the fused scorer: row [M, F+1], mu, col [N, F+1],
    user_ids [B] and cand [B, C] with about ``pad_p`` SENTINEL slots."""
    cand = rng.integers(0, N, (B, C))
    cand[rng.random((B, C)) < pad_p] = SENTINEL
    return (torch.tensor(rng.normal(size=(M, F + 1)), dtype=torch.float32),
            torch.tensor(2.75),
            torch.tensor(rng.normal(size=(N, F + 1)), dtype=torch.float32),
            torch.tensor(rng.integers(0, M, B), dtype=torch.int32),
            torch.tensor(cand, dtype=torch.int32))


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("n_seeds,cap,C,excl", [
    (4, 8, 32, ()), (8, 4, 64, (1, 9)), (2, 16, 24, (SENTINEL,)),
    (16, 8, 704, tuple(range(0, 640, 10)))])
def test_lsh_retrieve_kernel_equals_plain(cuda, tail, n_seeds, cap, C, excl):
    _, sp, sigs, index = _state()
    if tail:
        index = insert(index, sigs[:, :20], torch.arange(1500, 1520))
    users = torch.arange(0, 960, 40, dtype=torch.int32)
    seeds = seed_items(sp, users, n_seeds=n_seeds, window=64)
    starts, lens = window_slices(index, seeds, cap=cap)
    extra = (tail_hits(index, seeds) if tail else
             torch.full((users.shape[0], 1), SENTINEL, dtype=torch.int32))
    exclude = torch.tensor(list(excl) or [SENTINEL], dtype=torch.int32)
    ops = [x.to(cuda) for x in (starts, lens, extra,
                                padded_flat_ids(index, cap=cap), exclude)]
    C = min(C, starts.shape[1] * cap + extra.shape[1])
    before = lsh_kernel.LAUNCHES
    got = lsh_kernel.lsh_retrieve_topc(*ops, C=C, cap=cap)
    torch.cuda.synchronize()
    assert lsh_kernel.LAUNCHES == before + 1
    assert torch.equal(got, lsh_retrieve_topc_ref(*ops, C=C, cap=cap))
    assert torch.equal(got.cpu(), lsh_retrieve_topc_ref(
        *(x.cpu() for x in ops), C=C, cap=cap))



def _pool_case(B, I, cap, X, E, rng):
    """Synthetic operands of `lsh_retrieve_topc`: windows over a flat id
    plane of few distinct ids (duplicates within and across windows,
    SENTINEL holes), random lengths, tail extras, and an exclude set
    drawn from the same ids (so excluded ids sit in the windows).  The
    first user has empty windows and no extras: an all-SENTINEL row."""
    n_ids = max(16, (I * cap + X) // 3)
    flat = rng.integers(0, n_ids, 4 * I * cap + 64).astype(np.int32)
    flat[rng.random(flat.shape[0]) < 0.05] = SENTINEL
    flat = np.concatenate([flat, np.full(cap, SENTINEL, np.int32)])
    starts = rng.integers(0, flat.shape[0] - cap + 1, (B, I))
    lens = rng.integers(0, cap + 1, (B, I))
    extra = rng.integers(0, n_ids + 50, (B, X))
    extra[rng.random((B, X)) < 0.3] = SENTINEL
    lens[0], extra[0] = 0, SENTINEL
    exclude = rng.integers(0, n_ids, E)
    exclude[:: 7] = SENTINEL
    return [torch.tensor(a, dtype=torch.int32)
            for a in (starts, lens, extra, flat, exclude)]


@pytest.mark.parametrize("I,cap,X,E", [
    (1, 4, 1, 1),         # Wp = 8: one warp, padded to 32 keys
    (3, 8, 2, 3),         # Wp = 32
    (7, 8, 1, 5),         # 64
    (15, 8, 3, 64),       # 128
    (30, 8, 4, 64),       # 256
    (60, 8, 1, 64),       # 512
    (100, 8, 7, 200),     # 1024
    (160, 8, 1, 64),      # 2048: the serving flush's I, cap, X, E
    (500, 8, 9, 64),      # 4096
    (1000, 8, 1, 300),    # 8192
    (2000, 8, 5, 64),     # 16384
    (2000, 8, 5, 25344)])  # 16384 with the most exclude ids that fit
def test_lsh_retrieve_kernel_every_pool_width(cuda, I, cap, X, E):
    """Bit-exact against the plain version at every pool width the
    wrapper takes, with C = I·cap + X (every survivor) and a small C."""
    B = 2 if E > 1000 else 6
    ops = [x.to(cuda) for x in _pool_case(B, I, cap, X, E,
                                          np.random.default_rng(I + E))]
    W = I * cap + X
    for C in (W, min(W, 33)):
        before = lsh_kernel.LAUNCHES
        got = lsh_kernel.lsh_retrieve_topc(*ops, C=C, cap=cap)
        torch.cuda.synchronize()
        assert lsh_kernel.LAUNCHES == before + 1
        want = lsh_retrieve_topc_ref(*ops, C=C, cap=cap)
        assert torch.equal(got, want)
        assert bool((got[0] == SENTINEL).all())
        assert bool((got[1:] != SENTINEL).any())
    ex = ops[4][ops[4] != SENTINEL]
    assert not bool(torch.isin(got, ex).any())


def test_lsh_retrieve_refuses_a_pool_past_shared_memory(cuda):
    ops = [x.to(cuda) for x in _pool_case(2, 2000, 8, 5, 25345,
                                          np.random.default_rng(0))]
    with pytest.raises(ValueError, match="shared memory"):
        lsh_kernel.lsh_retrieve_topc(*ops, C=10, cap=8)
    ops = [x.to(cuda) for x in _pool_case(2, 4096, 8, 1, 1,
                                          np.random.default_rng(0))]
    with pytest.raises(ValueError, match="shared memory"):
        lsh_kernel.lsh_retrieve_topc(*ops, C=10, cap=8)

@pytest.mark.parametrize("B,C,F,topn", [
    (32, 64, 16, 10), (7, 33, 8, 5), (250, 768, 48, 10), (9, 16, 8, 16),
    (5, 10, 48, 10), (256, 700, 48, 10), (13, 2048, 48, 32),
    (3, 768, 128, 10), (6, 40, 250, 3), (10, 768, 48, 50),
    (5, 300, 300, 10), (4, 130, 300, 100), (3, 64, 8, 64)])
def test_candidate_score_kernel_equals_plain(cuda, B, C, F, topn):
    ops = [x.to(cuda) for x in _flush_args(B, C, F, 300,
                                           np.random.default_rng(B + C))]
    before = score_kernel.LAUNCHES
    s, items = score_kernel.score_topn(*ops, topn=topn)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES == before + 1
    assert_topn_close(s, items, *score_topn_ref(*ops, topn=topn))


def test_candidate_score_kernel_all_masked_and_tied(cuda):
    row, mu, col, users, cand = _flush_args(12, 40, 8, 6,
                                            np.random.default_rng(3),
                                            pad_p=0.0)
    cand[:4] = SENTINEL                           # all-SENTINEL rows
    cand[4] = torch.tensor([2, 5] * 20)           # exact ties: repeated ids
    ops = [x.to(cuda) for x in (row, mu, col, users, cand)]
    s, items = score_kernel.score_topn(*ops, topn=12)
    s_w, i_w = score_topn_ref(*ops, topn=12)
    assert torch.equal(items[:4], i_w[:4]) and torch.equal(s[:4], s_w[:4])
    assert bool((s[:4] == NEG).all() and (items[:4] == SENTINEL).all())
    assert torch.equal(s[4], s_w[4]) and torch.equal(items[4], i_w[4])
    assert_topn_close(s, items, s_w, i_w)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        lsh_kernel.lsh_retrieve_topc(x, x, x, x[0], x[0], C=2, cap=1)
    f = torch.zeros((4, 5), device=cuda)
    mu = torch.tensor(1.0, device=cuda)
    u = torch.zeros(4, dtype=torch.int32, device=cuda)
    c = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        score_kernel.score_topn(f, mu, f.t().contiguous().t(), u, c, topn=2)
    with pytest.raises(TypeError):
        score_kernel.score_topn(f, mu, f, u.long(), c, topn=2)
    with pytest.raises(ValueError, match="disagree"):
        score_kernel.score_topn(f, mu, f[:, :4].contiguous(), u, c, topn=2)
    with pytest.raises(ValueError, match="disagree"):
        score_kernel.score_topn(f, mu, f, u[:3], c, topn=2)
    with pytest.raises(ValueError, match="mu"):
        score_kernel.score_topn(f, mu.double(), f, u, c, topn=2)
    with pytest.raises(ValueError, match="topn"):
        score_kernel.score_topn(f, mu, f, u, c, topn=9)
    wide = torch.zeros((4, 60000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        score_kernel.score_topn(f, mu, f, u, wide, topn=33)


def test_service_on_card_launches_both_kernels_and_matches_cpu(cuda):
    """``impl="cuda"``: the kernel walk on the card, its kernels' plain
    versions on the CPU (the default on the CPU is the plain walk)."""
    params, sp, _, index = _state()
    cfg = ServeConfig(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
                      n_popular=16, tile_b=8, band_budget=256, impl="cuda")
    users = np.arange(0, 960, 3, dtype=np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        svc = RecsysService(params, index, sp, cfg, device=dev)
        before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
        svc.warmup()
        svc.submit(users)
        svc.flush()
        res = svc.take_results()
        out[dev] = (np.concatenate([r[1] for r in res]),
                    np.concatenate([r[2] for r in res]))
        n = (lsh_kernel.LAUNCHES - before[0], score_kernel.LAUNCHES - before[1])
        want = svc.stats()["batches"] + 1 if dev == "cuda" else 0
        assert n == (want, want)                  # + the warmup flush
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    assert (out["cuda"][1] == out["cpu"][1]).mean() > 0.99


# ------------------------------------------------------------ fused SGD steps

def fused_case(B, F, K, rng, *, valid_p=0.5, device="cpu"):
    """Packed planes, a conflict-free `Batch` of ``B`` slots (distinct i
    and j, any neighbour cols, about ``valid_p`` of the slots valid, W and
    C non-zero) and a hyper vector [13] for the fused CULSH-MF step."""
    M, N = 2 * B + 3, 2 * B + 5
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    pp = model.PackedParams(row=a(M, F + 1), col=a(N, F + 2 * K + 1),
                            mu=torch.tensor(3.25), F=F, K=K)
    ids = lambda n: torch.tensor(rng.permutation(n)[:B], dtype=torch.int32)
    expl = torch.tensor(rng.integers(0, 2, (B, K)), dtype=torch.float32)
    valid = torch.tensor(rng.random(B) < valid_p, dtype=torch.float32)
    bt = model.Batch(ids(M), ids(N), a(B),
                     torch.tensor(rng.integers(0, N, (B, K)),
                                  dtype=torch.int32),
                     a(B, K), expl, 1.0 - expl, valid)
    hp = torch.cat([a(12).abs() * 0.05, pp.mu[None]])
    return _to(pp, device), _to(bt, device), hp.to(device)


def _to(x, device):
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def _copy(pp):
    return dataclasses.replace(pp, row=pp.row.clone(), col=pp.col.clone())


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _fused_equals_plain(pp, bt, hp, bce=False):
    """One launch of the fused step on a copy of the planes against the
    plain gather → step → delta scatter on another → the kernel's
    planes."""
    before = sgd_kernel.CULSH_LAUNCHES
    got = sgd_kernel.culsh_sgd_batch(_copy(pp), bt, hp, bce=bce)
    torch.cuda.synchronize()
    assert sgd_kernel.CULSH_LAUNCHES == before + 1
    want = apply_culsh_sgd_ref(_copy(pp), bt, hp, bce=bce)
    _close((got.row, got.col), (want.row, want.col))
    return got


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B,F,K", [(512, 128, 64), (7, 128, 64),
                                   (250, 128, 64), (24, 8, 4), (33, 40, 5),
                                   (40, 200, 100), (40, 300, 150),
                                   (12, 520, 260)])
def test_culsh_sgd_kernel_equals_plain(cuda, B, F, K, bce):
    pp, bt, hp = fused_case(B, F, K, np.random.default_rng(B + F),
                            device=cuda)
    got = _fused_equals_plain(pp, bt, hp, bce)
    off = bt.valid == 0                      # invalid slots: bit for bit
    assert torch.equal(got.row[bt.i[off].long()], pp.row[bt.i[off].long()])
    assert torch.equal(got.col[bt.j[off].long()], pp.col[bt.j[off].long()])


MF_HP = (0.02, 0.03, 0.01, 0.02)        # (γu, γv, λu, λv)


def _mf_equals_plain(pp, bt, hp, bce=False):
    """One launch of the fused CUSGD++ step on a copy of the planes
    against `apply_mf_sgd_ref` on another → the kernel's planes."""
    before = sgd_kernel.MF_LAUNCHES
    got = sgd_kernel.mf_sgd_batch(_copy(pp), bt, hp, bce=bce)
    torch.cuda.synchronize()
    assert sgd_kernel.MF_LAUNCHES == before + 1
    want = apply_mf_sgd_ref(_copy(pp), bt, hp, bce=bce)
    _close((got.row, got.col), (want.row, want.col))
    return got


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B,F", [(512, 128), (7, 128), (250, 128), (9, 40),
                                 (33, 300), (12, 520)])
def test_mf_sgd_kernel_equals_plain(cuda, B, F, bce):
    """The fused step reads U[i] and V[j] by id with the planes' own row
    widths (the col plane carries K = 3 neighbour columns), writes only
    the first F columns of live slots' rows, and leaves invalid slots'
    rows bit for bit."""
    pp, bt, _ = fused_case(B, F, 3, np.random.default_rng(B * 3 + F),
                           device=cuda)
    hp = torch.tensor(MF_HP, device=cuda)
    got = _mf_equals_plain(pp, bt, hp, bce)
    assert torch.equal(got.row[:, F:], pp.row[:, F:])
    assert torch.equal(got.col[:, F:], pp.col[:, F:])
    off = bt.valid == 0
    assert torch.equal(got.row[bt.i[off].long()], pp.row[bt.i[off].long()])
    assert torch.equal(got.col[bt.j[off].long()], pp.col[bt.j[off].long()])


def test_sgd_kernels_all_invalid_rows_are_copies(cuda):
    pp, bt, hp = fused_case(64, 128, 64, np.random.default_rng(1),
                            valid_p=0.0, device=cuda)
    got = sgd_kernel.culsh_sgd_batch(_copy(pp), bt, hp)
    assert torch.equal(got.row, pp.row) and torch.equal(got.col, pp.col)
    for bce in (False, True):
        got = sgd_kernel.mf_sgd_batch(_copy(pp), bt,
                                      torch.full((4,), 0.1, device=cuda),
                                      bce=bce)
        assert torch.equal(got.row, pp.row) and torch.equal(got.col, pp.col)


def test_culsh_step_padding_slots_repeating_live_ids_add_nothing(cuda):
    """A schedule window reads past its batch's fill: an invalid slot may
    carry the i and j of a valid one.  It must write nothing, so the
    planes equal those of the batch without the padding slots, bit for
    bit."""
    rng = np.random.default_rng(4)
    M, N, F, K, B = 40, 30, 128, 64, 12
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    pp0 = model.PackedParams(row=a(M, F + 1), col=a(N, F + 2 * K + 1),
                             mu=torch.tensor(3.5), F=F, K=K)
    i = torch.tensor(rng.permutation(M)[:B], dtype=torch.int32)
    j = torch.tensor(rng.permutation(N)[:B], dtype=torch.int32)
    nb = torch.tensor(rng.integers(0, N, (B, K)), dtype=torch.int32)
    nb[0, :4] = j[1]                 # a neighbour col that is another j
    expl = torch.tensor(rng.integers(0, 2, (B, K)), dtype=torch.float32)
    valid = torch.ones(B)
    pad = [8, 9, 10, 11]
    i[pad] = i[:4].clone()           # padding repeats live ids
    j[pad] = j[:4].clone()
    valid[pad] = 0.0
    bt = model.Batch(i, j, a(B), nb, a(B, K), expl, 1.0 - expl, valid)
    live = model.Batch(*(getattr(bt, f.name)[:8]
                         for f in dataclasses.fields(bt)))
    hpv = culsh_hyper(sgd.Hyper(), 0.9, pp0.mu)
    got = sgd_kernel.culsh_sgd_batch(_to(pp0, cuda), _to(bt, cuda),
                                     hpv.to(cuda))
    want = sgd_kernel.culsh_sgd_batch(_to(pp0, cuda), _to(live, cuda),
                                      hpv.to(cuda))
    assert torch.equal(got.row, want.row) and torch.equal(got.col, want.col)
    plain = apply_culsh_sgd_ref(_to(pp0, "cpu"), bt, hpv)
    np.testing.assert_allclose(got.col.cpu().numpy(), plain.col.numpy(),
                               rtol=1e-5, atol=1e-6)



def test_mf_step_padding_slots_repeating_live_ids_add_nothing(cuda):
    """As for the CULSH-MF step: invalid slots that carry the i and j of
    valid ones write nothing, so the planes equal those of the batch
    without them, bit for bit."""
    pp, bt, _ = fused_case(16, 128, 4, np.random.default_rng(5),
                           valid_p=1.0)
    pad = [12, 13, 14, 15]
    bt.i[pad], bt.j[pad] = bt.i[:4].clone(), bt.j[:4].clone()
    bt.valid[pad] = 0.0
    live = model.Batch(*(getattr(bt, f.name)[:12]
                         for f in dataclasses.fields(bt)))
    hp = torch.tensor(MF_HP)
    got = sgd_kernel.mf_sgd_batch(_to(pp, cuda), _to(bt, cuda), hp.to(cuda))
    want = sgd_kernel.mf_sgd_batch(_to(pp, cuda), _to(live, cuda),
                                   hp.to(cuda))
    assert torch.equal(got.row, want.row) and torch.equal(got.col, want.col)
    plain = apply_mf_sgd_ref(_copy(pp), bt, hp)
    _close((got.row, got.col), (plain.row, plain.col))


def test_mf_step_replays_in_a_cuda_graph(cuda):
    """The fused CUSGD++ launch captured in a CUDA graph (as
    `chip_smoke.py` times it) replays the eager launches bit for bit."""
    pp, bt, _ = fused_case(512, 128, 2, np.random.default_rng(8),
                           valid_p=0.9, device=cuda)
    pp.row.mul_(0.1)
    pp.col.mul_(0.1)
    hp = mf_hyper(sgd.Hyper(), 1.0, cuda)
    eager, graphed = _copy(pp), _copy(pp)
    for _ in range(5):
        sgd_kernel.mf_sgd_batch(eager, bt, hp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sgd_kernel.mf_sgd_batch(_copy(pp), bt, hp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(5):
            sgd_kernel.mf_sgd_batch(graphed, bt, hp)
    torch.cuda.synchronize()
    assert torch.equal(graphed.row, pp.row)     # capture ran nothing
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(eager.row, pp.row)
    assert torch.equal(graphed.row, eager.row)
    assert torch.equal(graphed.col, eager.col)

def hazard_case(B, F, K, rng, device):
    """`fused_case` with every slot valid and every explicit neighbour of
    every slot another live slot's j: the batch in which a step that read
    a b̂ after another slot had written it would be off."""
    pp, bt, hp = fused_case(B, F, K, rng, valid_p=1.0)
    nxt = (torch.arange(B)[:, None] + 1 + torch.arange(K)[None, :]) % B
    bt = dataclasses.replace(bt, nb=bt.j[nxt], expl=torch.ones((B, K)),
                             impl=torch.zeros((B, K)))
    hp[1], hp[4] = 0.3, 0.05         # b̂ and W move enough to show
    return _to(pp, device), _to(bt, device), hp.to(device)


def test_culsh_step_reads_neighbour_baselines_before_any_write(cuda):
    """The hazard batch, launched 20 times from the same planes: every
    launch within tolerance of the plain version, which gathers every
    b̂[nb] before any write; applying the slots one at a time (reading
    updated b̂) falls outside it."""
    pp, bt, hp = hazard_case(512, 128, 64, np.random.default_rng(9), cuda)
    for _ in range(20):
        got = _fused_equals_plain(pp, bt, hp)
    stale = _copy(pp)
    for s in range(bt.i.shape[0]):
        apply_culsh_sgd_ref(stale, model.Batch(*(
            getattr(bt, f.name)[s:s + 1] for f in dataclasses.fields(bt))),
            hp)
    with pytest.raises(AssertionError):
        _close((stale.col,), (got.col,))


def test_culsh_step_replays_in_a_cuda_graph(cuda):
    """The cooperative launch captured in a CUDA graph (as `chip_smoke.py`
    times it) replays the same launches made eagerly, bit for bit."""
    pp, bt, _ = fused_case(512, 128, 64, np.random.default_rng(7),
                           valid_p=0.9, device=cuda)
    pp.row.mul_(0.1)                 # five steps stay finite
    pp.col.mul_(0.1)
    hp = culsh_hyper(sgd.Hyper(), 1.0, pp.mu)
    eager, graphed = _copy(pp), _copy(pp)
    for _ in range(5):
        sgd_kernel.culsh_sgd_batch(eager, bt, hp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):    # warm up off the capture stream
        sgd_kernel.culsh_sgd_batch(_copy(pp), bt, hp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(5):
            sgd_kernel.culsh_sgd_batch(graphed, bt, hp)
    torch.cuda.synchronize()
    assert torch.equal(graphed.col, pp.col)     # capture ran nothing
    graph.replay()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(eager.col).all())
    assert torch.equal(graphed.row, eager.row)
    assert torch.equal(graphed.col, eager.col)


def test_culsh_tier_on_card_equals_plain_epoch(cuda):
    """One scheduled epoch on the card through `culsh_sgd_tier` (every
    tier, their partial last batches included) against the same epoch on
    the CPU's plain steps; one launch per conflict-free batch."""
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=90,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    sp = from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    K, F = 8, 16
    rng = np.random.default_rng(0)
    JK = torch.tensor(rng.integers(0, spec.N, (spec.N, K)), dtype=torch.int32)
    sched = sparse.conflict_free_schedule(
        sp.rows.numpy(), sp.cols.numpy(), batch=64, tiers=3, M=spec.M,
        N=spec.N, seed=0)
    assert any((~v).any() for v in sched.tier_valid)   # partial batches
    sd = model.build_scheduled_data(sp, JK, sched)
    p = model.init_from_data(prng.PRNGKey(1), sp, F, K)
    p = dataclasses.replace(p, W=torch.randn(spec.N, K) * 0.1,
                            C=torch.randn(spec.N, K) * 0.1)
    pp = model.pack_params(p)
    key = prng.PRNGKey(2)
    before = sgd_kernel.CULSH_LAUNCHES
    got = sgd.train_epoch_scheduled(_copy(_to(pp, cuda)), _to(sd, cuda),
                                    sched, key, 1, sgd.Hyper(),
                                    use_kernels=True)
    torch.cuda.synchronize()
    assert sgd_kernel.CULSH_LAUNCHES - before == sched.stats()["nb_cf"]
    want = sgd.train_epoch_scheduled(_copy(pp), sd, sched, key, 1,
                                     sgd.Hyper(), use_kernels=False)
    np.testing.assert_allclose(got.row.cpu().numpy(), want.row.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.col.cpu().numpy(), want.col.numpy(),
                               rtol=1e-5, atol=1e-5)



def test_mf_tier_on_card_equals_plain_epoch(cuda):
    """One plain-MF (``mf_only``) scheduled epoch on the card through
    `mf_sgd_tier` against the same epoch on the CPU's packed steps; one
    launch per conflict-free batch."""
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=90,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    sp = from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    sched = sparse.conflict_free_schedule(
        sp.rows.numpy(), sp.cols.numpy(), batch=64, tiers=3, M=spec.M,
        N=spec.N, seed=0)
    JK = torch.zeros((spec.N, 8), dtype=torch.int32)
    sd = model.build_scheduled_data(sp, JK, sched, mf_only=True)
    pp = model.pack_params(model.init_from_data(prng.PRNGKey(1), sp, 16, 8))
    key = prng.PRNGKey(2)
    before = sgd_kernel.MF_LAUNCHES
    got = sgd.train_epoch_scheduled(_copy(_to(pp, cuda)), _to(sd, cuda),
                                    sched, key, 1, sgd.Hyper(), mf_only=True,
                                    use_kernels=True)
    torch.cuda.synchronize()
    assert sgd_kernel.MF_LAUNCHES - before == sched.stats()["nb_cf"]
    want = sgd.train_epoch_scheduled(_copy(pp), sd, sched, key, 1,
                                     sgd.Hyper(), mf_only=True,
                                     use_kernels=False)
    np.testing.assert_allclose(got.row.cpu().numpy(), want.row.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.col.cpu().numpy(), want.col.numpy(),
                               rtol=1e-5, atol=1e-5)

def test_fit_on_card_launches_the_culsh_kernel_per_cf_step(cuda):
    from repro_torch.train.trainer import FitConfig, fit
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=90,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    cfg = FitConfig(F=16, K=8, epochs=2, cf_batch=64, use_kernels=True,
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16))
    before = sgd_kernel.CULSH_LAUNCHES
    res = fit(tr, te, (spec.M, spec.N), cfg)
    n = sgd_kernel.CULSH_LAUNCHES - before
    assert n == res.schedule_stats["nb_cf"] * cfg.epochs
    assert res.params.U.device.type == "cuda"
    cpu = fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
    for (_, _, a), (_, _, b) in zip(res.history, cpu.history):
        assert abs(a - b) < 1e-4


def test_sgd_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pp, bt, hp = fused_case(8, 8, 4, np.random.default_rng(0), device=cuda)
    with pytest.raises(ValueError, match="disagree"):
        sgd_kernel.culsh_sgd_batch(dataclasses.replace(
            pp, col=pp.col[:, :-1].contiguous()), bt, hp)
    with pytest.raises(TypeError):
        sgd_kernel.culsh_sgd_batch(pp, dataclasses.replace(
            bt, i=bt.i.long()), hp)
    with pytest.raises(ValueError, match="disagrees"):
        sgd_kernel.culsh_sgd_batch(pp, dataclasses.replace(
            bt, nb=bt.nb[:, :2].contiguous()), hp)
    with pytest.raises(ValueError, match="hp"):
        sgd_kernel.culsh_sgd_batch(pp, bt, hp[:4])
    with pytest.raises(ValueError, match="F=0"):
        sgd_kernel.culsh_sgd_batch(dataclasses.replace(pp, F=0), bt, hp)
    valid = torch.ones((2, 8), device=cuda)
    with pytest.raises(ValueError, match="past"):
        sgd_kernel.culsh_sgd_tier(pp, bt, valid, hp, width=8,
                                  starts=np.array([0, 4]))
    with pytest.raises(ValueError, match="slot masks"):
        sgd_kernel.culsh_sgd_tier(pp, bt, valid, hp, width=8,
                                  starts=np.array([0]))
    big = 1 << 22                   # more slots than one grid can hold
    z = torch.zeros(big, dtype=torch.int32, device=cuda)
    zk = torch.zeros((big, 4), device=cuda)
    wide = model.Batch(z, z, zk[:, 0].contiguous(), z[:, None].expand(
        big, 4).contiguous(), zk, zk, zk, torch.zeros(big, device=cuda))
    with pytest.raises(ValueError, match="co-resident"):
        sgd_kernel.culsh_sgd_batch(pp, wide, hp)
    hmf = hp[:4].contiguous()
    with pytest.raises(ValueError, match="hp"):
        sgd_kernel.mf_sgd_batch(pp, bt, hp)
    with pytest.raises(ValueError, match="F=0"):
        sgd_kernel.mf_sgd_batch(dataclasses.replace(pp, F=0), bt, hmf)
    with pytest.raises(ValueError, match="disagree"):
        sgd_kernel.mf_sgd_batch(dataclasses.replace(
            pp, row=pp.row[:, :-1].contiguous()), bt, hmf)
    with pytest.raises(TypeError):
        sgd_kernel.mf_sgd_batch(pp, dataclasses.replace(bt, j=bt.j.long()),
                                hmf)
    with pytest.raises(ValueError, match="past"):
        sgd_kernel.mf_sgd_tier(pp, bt, valid, hmf, width=8,
                               starts=np.array([0, 4]))
    with pytest.raises(ValueError, match="slot masks"):
        sgd_kernel.mf_sgd_tier(pp, bt, valid, hmf, width=8,
                               starts=np.array([0]))


# ------------------------------------------- simLSH encode, fused prediction

def _encode_args(N, deg, bits, rng, device, signs=True):
    psi = torch.tensor(rng.normal(size=(N, deg)), dtype=torch.float32,
                       device=device)
    draw = (rng.choice([-1.0, 1.0], size=(N, deg, bits)) if signs
            else rng.normal(size=(N, deg, bits)))
    return psi, torch.tensor(draw, dtype=torch.float32, device=device)


@pytest.mark.parametrize("N,deg,bits", [(8, 16, 16), (37, 64, 24),
                                        (128, 32, 30), (5, 8, 8), (1, 8, 30),
                                        (1000, 24, 18), (33, 130, 18)])
def test_simlsh_encode_kernel_equals_plain(cuda, N, deg, bits):
    psi, phi = _encode_args(N, deg, bits, np.random.default_rng(N + deg),
                            cuda)
    before = se_kernel.LAUNCHES
    got = se_kernel.simlsh_encode(psi, phi)
    torch.cuda.synchronize()
    assert se_kernel.LAUNCHES == before + 1
    want = simlsh_encode_ref(psi, phi)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    # Φ = ±1: every product is exact and both sum over d in order
    assert torch.equal(got, want)
    psi, phi = _encode_args(N, deg, bits, np.random.default_rng(N), cuda,
                            signs=False)
    np.testing.assert_allclose(se_kernel.simlsh_encode(psi, phi).cpu(),
                               simlsh_encode_ref(psi, phi).cpu(),
                               rtol=1e-5, atol=1e-5)


def test_encode_band_on_card_launches_the_kernel_and_matches_cpu(cuda):
    _, sp, _, _ = _state()
    cfg = simlsh.SimLSHConfig(G=9, p=2, q=3)
    key = prng.PRNGKey(0)
    for band in range(cfg.q):
        before = se_kernel.LAUNCHES
        got = encode_band(sp.to(cuda), cfg, key, band, deg=24)
        assert se_kernel.LAUNCHES == before + 1
        want = encode_band(sp, cfg, key, band, deg=24)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        S = simlsh.band_accumulate(sp.rows, sp.cols, sp.vals, key, band,
                                   N=sp.N, bits=cfg.sig_bits,
                                   psi_pow=cfg.psi_pow)
        np.testing.assert_allclose(got.cpu().numpy(), S.numpy(), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("B,F,K", [(64, 16, 8), (100, 32, 16), (3, 8, 4),
                                   (256, 128, 32), (1, 128, 64),
                                   (33, 40, 5), (8192, 128, 64)])
def test_neighbor_predict_kernel_equals_plain(cuda, B, F, K):
    rng = np.random.default_rng(B + F + K)
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                device=cuda)
    args = (a(B, F), a(B, F), a(B, K), a(B, K), a(B, K), a(B, K), a(B),
            a(B), a(B))
    before = np_kernel.LAUNCHES
    got = np_kernel.neighbor_predict(*args)
    torch.cuda.synchronize()
    assert np_kernel.LAUNCHES == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               neighbor_predict_ref(*args).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_predict_batch_on_card_matches_model_predict(cuda):
    params, sp, _, _ = _state()
    rng = np.random.default_rng(2)
    N, K = sp.N, 6
    params = dataclasses.replace(
        params, W=torch.tensor(0.1 * rng.normal(size=(N, K)),
                               dtype=torch.float32),
        C=torch.tensor(0.1 * rng.normal(size=(N, K)), dtype=torch.float32))
    JK = torch.tensor(rng.integers(0, N, (N, K)), dtype=torch.int32)
    bt = model.assemble(sp, JK, torch.arange(0, sp.nnz, 7), torch.ones(
        len(range(0, sp.nnz, 7))))
    to = lambda x: type(x)(*(getattr(x, f.name).to(cuda)
                             for f in dataclasses.fields(x)))
    before = np_kernel.LAUNCHES
    got = predict_batch(to(params), to(bt))
    assert np_kernel.LAUNCHES == before + 1
    want = model.predict(params, bt)[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_encode_predict_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    psi, phi = _encode_args(4, 8, 18, np.random.default_rng(0), cuda)
    with pytest.raises(ValueError, match="disagree"):
        se_kernel.simlsh_encode(psi, phi[:, :4].contiguous())
    with pytest.raises(ValueError, match="bits"):
        se_kernel.simlsh_encode(psi, torch.ones((4, 8, 33), device=cuda))
    with pytest.raises(TypeError):
        se_kernel.simlsh_encode(psi.double(), phi)
    with pytest.raises(ValueError, match="contiguous"):
        se_kernel.simlsh_encode(psi.t().contiguous().t(), phi)
    a = torch.zeros((5, 8), device=cuda)
    k = torch.zeros((5, 3), device=cuda)
    v = torch.zeros((5,), device=cuda)
    with pytest.raises(ValueError, match="expected"):
        np_kernel.neighbor_predict(a, a[:4], k, k, k, k, v, v, v)
    with pytest.raises(ValueError, match="sN"):
        np_kernel.neighbor_predict(a, a, k, k, k, k, v, v, v[:3])
    with pytest.raises(TypeError):
        np_kernel.neighbor_predict(a, a, k, k, k.double(), k, v, v, v)


# ------------------------------------------------ online learning (Alg. 4)

def _online_state(M=300, N=80, seed=0):
    """`tests/test_online.py::small_state`'s recipe in the port alone (on
    the CPU): ratings, accumulators, J^K and initial parameters."""
    from repro_torch.core import online, topk
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=M, N=N, nnz=6000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=seed)
    sp = from_coo(rows, cols, vals, (M, N), device="cpu")
    lsh = simlsh.SimLSHConfig(G=8, p=1, q=6)
    key = prng.PRNGKey(0)
    sigs, S = simlsh.encode(sp, lsh, key, return_accumulators=True)
    JK = topk.topk_from_signatures(sigs, prng.PRNGKey(1), K=8,
                                   band_cap=lsh.band_cap)
    params = model.init_from_data(prng.PRNGKey(2), sp, 16, 8)
    return online.OnlineState(params=params, S=S, JK=JK, sp=sp, M=M, N=N,
                              hash_key=key), lsh


def _online_delta(st, M2, N2, n=800, seed=3):
    rng = np.random.default_rng(seed)
    key = (rng.integers(0, M2, n).astype(np.int64) * N2
           + rng.integers(0, N2, n))
    old = (st.sp.rows.cpu().numpy().astype(np.int64) * N2
           + st.sp.cols.cpu().numpy())
    key = np.setdiff1d(np.unique(key), old)
    return ((key // N2).astype(np.int32), (key % N2).astype(np.int32),
            rng.uniform(1, 5, key.shape[0]).astype(np.float32))


def _state_to(st, device):
    return dataclasses.replace(st, params=st.params.to(device),
                               S=st.S.to(device), JK=st.JK.to(device),
                               sp=st.sp.to(device))


def test_online_update_on_card_matches_cpu(cuda):
    """Old slices bit for bit on the card; new ones within 1e-4 of the
    port's CPU run (collisions add in atomic order on the card)."""
    from repro_torch.core import online
    from repro_torch.core.sgd import Hyper
    st, lsh = _online_state()
    M2, N2 = st.M + 40, st.N + 12
    d = _online_delta(st, M2, N2)
    kw = dict(M_new=M2, N_new=N2, K=8, epochs=2)
    cpu = online.online_update(st, *d, lsh, Hyper(), prng.PRNGKey(9), **kw)
    gpu_st = _state_to(st, cuda)
    gpu = online.online_update(gpu_st, *d, lsh, Hyper(), prng.PRNGKey(9),
                               **kw)
    for f in ("U", "b", "V", "bh", "W", "C"):
        n = st.M if f in ("U", "b") else st.N
        g = getattr(gpu.params, f)
        assert g.device.type == "cuda"
        assert torch.equal(g[:n], getattr(gpu_st.params, f)), f
        np.testing.assert_allclose(g.cpu().numpy(),
                                   getattr(cpu.params, f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert torch.equal(gpu.JK.cpu(), cpu.JK)
    assert torch.equal(gpu.sp.rows.cpu(), cpu.sp.rows)
    np.testing.assert_allclose(gpu.S.cpu().numpy(), cpu.S.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_flush_after_ingest_walks_the_tail_on_card(cuda):
    """After `ingest` puts items in the tail, a flush's kernel path equals
    the plain versions (`impl="ref"`): ids bit for bit."""
    params, sp, sigs, index = _state()
    cfg = ServeConfig(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
                      n_popular=16, tile_b=8, band_budget=256)
    svc = RecsysService(params, index, sp, cfg, device=cuda)
    svc.ingest(sigs[:, 5:25].to(cuda),
               torch.arange(1500, 1520, dtype=torch.int32, device=cuda))
    assert svc.index.tail_fill == 20
    users = torch.arange(0, 960, 15, dtype=torch.int32, device=cuda)
    kw = dict(n_seeds=8, cap=8, C=128, window=64, tail_scan=True, topn=10,
              tile_b=8)
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    got = recommend_walked_kernel(svc.planes, svc.index, svc.sp, users,
                                  svc.popular, svc._flat_ids(), **kw)
    torch.cuda.synchronize()
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == (before[0] + 1,
                                                            before[1] + 1)
    want = recommend_walked_kernel(svc.planes, svc.index, svc.sp, users,
                                   svc.popular, svc._flat_ids(), impl="ref",
                                   **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1], want[1])
    cand = retrieve_candidates(svc.index, svc.sp, users, n_seeds=8, cap=8,
                               C=128, popular=svc.popular)
    assert bool(((cand >= 1500) & (cand < 1520)).any())


def test_check_divergence_on_card_tensors(cuda):
    from repro_torch.core import online
    from repro_torch.resil import check_divergence
    st, _ = _online_state()
    p0 = st.params
    p = online.grow_params(p0, st.M + 10, st.N + 4, prng.PRNGKey(3))
    on = lambda q: q.to(cuda)
    assert check_divergence(on(p), on(p0), M_old=st.M, N_old=st.N) == \
        check_divergence(p, p0, M_old=st.M, N_old=st.N) == []
    bad = dataclasses.replace(p, V=p.V.clone(), b=p.b.clone())
    bad.V[st.N + 1, 3] = float("nan")
    bad.b[st.M:] = 1e6
    got = check_divergence(on(bad), on(p0), M_old=st.M, N_old=st.N)
    assert got == check_divergence(bad, p0, M_old=st.M, N_old=st.N)
    assert [g.split(":")[0] for g in got] == ["b", "V"]


def test_full_topn_breaks_ties_like_top_k_on_card(cuda):
    """Items 500–999 with zero V rows and equal b̂ tie for every user; the
    lower id comes first, as `lax.top_k` orders them."""
    rng = np.random.default_rng(0)
    V = rng.normal(size=(1500, 16)).astype(np.float32) * 0.1
    bh = rng.normal(size=1500).astype(np.float32) * 0.1
    V[500:1000], bh[500:1000] = 0.0, 50.0
    z = np.zeros((1500, 1), np.float32)
    p = convert.params_from_numpy(rng.normal(size=(64, 16)), V,
                                  np.zeros(64), bh, z, z, 3.0, device=cuda)
    s, i = full_topn(p, torch.arange(64, dtype=torch.int32, device=cuda),
                     topn=20)
    assert torch.equal(i.cpu(), torch.arange(500, 520, dtype=torch.int32)
                       .expand(64, 20))
    s_cpu, i_cpu = full_topn(p.to("cpu"), torch.arange(64), topn=20)
    assert torch.equal(i.cpu(), i_cpu)


def test_fit_kernel_impl_ref_launches_nothing_and_compile_seconds(cuda):
    from repro_torch.kernels import _build
    from repro_torch.train.trainer import FitConfig, fit
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=200, N=60,
                               nnz=2000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    cfg = FitConfig(F=8, K=4, epochs=1, cf_batch=32, use_kernels=True,
                    kernel_impl="ref",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=4))
    before = sgd_kernel.CULSH_LAUNCHES
    ref = fit(tr, te, (spec.M, spec.N), cfg)
    assert sgd_kernel.CULSH_LAUNCHES == before and ref.compile_seconds == 0.0
    _build.library()                                  # loaded: nothing to do
    auto = fit(tr, te, (spec.M, spec.N),
               dataclasses.replace(cfg, kernel_impl="auto"))
    assert sgd_kernel.CULSH_LAUNCHES > before and auto.compile_seconds == 0.0
    assert abs(auto.history[-1][2] - ref.history[-1][2]) < 1e-4


# ------------------------------------------- deterministic scatter, resilience

def _zipf_ids(rng, n, hi):
    """``n`` ids below ``hi`` drawn with a few hot ones (runs past the
    add kernel's long-run threshold) among many rare ones."""
    return (rng.zipf(1.3, n) - 1) % hi


def _scatter_inputs(kind, rng):
    """(plane, width, idx, src) on the CPU: the scatter's dst is
    ``plane[:, :width]`` (a column slice of a wider plane) when ``width``
    is set, else the whole plane."""
    if kind == "hot id among singletons":       # one id carries 10,000 rows
        plane, width = torch.zeros(20000, 128), None
        idx = np.concatenate([np.full(10000, 7),
                              rng.permutation(np.arange(100, 20000))[:3000]])
        idx = idx[rng.permutation(idx.size)]
    elif kind.startswith("n = "):               # about the grouping threshold
        n = int(kind[4:].split()[0].replace(",", ""))
        plane, width = torch.zeros(3000, 40), None
        idx = _zipf_ids(rng, n, 3000)
    elif kind == "width 1 at n = 2e6":
        plane, width = torch.zeros(700000), None
        idx = _zipf_ids(rng, 2_000_000, 700000)
    elif kind == "LM row of width 7,168":
        plane, width = torch.zeros(2000, 7168), None
        idx = _zipf_ids(rng, 1024, 2000)
    elif kind in ("width 2", "width 5"):        # long runs, narrow tiles
        plane, width = torch.zeros(60, int(kind[-1])), None
        idx = rng.integers(0, 60, 3000)
    else:
        plane, width, n, hi = {
            "1-D": (torch.zeros(700), None, 5000, 700),
            "2-D": (torch.zeros(300, 33), None, 900, 300),
            "column slice": (torch.zeros(300, 257), 128, 512, 300),
            "fit leftover batch": (torch.zeros(3000, 257), None, 512, 3000),
            "all colliding": (torch.zeros(4, 9), None, 3000, 1)}[kind]
        idx = rng.integers(0, hi, n) + (2 if kind == "all colliding" else 0)
    plane.copy_(torch.tensor(rng.normal(size=plane.shape).astype(np.float32)))
    n = idx.size
    shape = (n,) + ((width,) if width else tuple(plane.shape[1:]))
    src = rng.normal(size=shape) * 10.0 ** rng.integers(-4, 5, shape)
    return plane, width, torch.tensor(idx), torch.tensor(
        src.astype(np.float32))


_SCATTER_KINDS = ["1-D", "2-D", "column slice", "fit leftover batch",
                  "all colliding", "hot id among singletons", "n = 8,191",
                  "n = 8,192", "n = 8,193", "width 1 at n = 2e6",
                  "LM row of width 7,168", "n = 1", "width 2", "width 5"]


@pytest.mark.parametrize("kind", _SCATTER_KINDS)
def test_segment_add_on_card_equals_cpu_index_add(cuda, kind):
    """The card's deterministic scatter gives the CPU's `index_add_` bits,
    and the same bits on every run (the atomic `index_add_` need not),
    with and without a plan; the columns outside a slice stay as they
    were.  Each call launches the add kernel once; without a plan it
    groups on the card (one grouping launch, no sort) up to
    `GROUP_MAX` ids, and sorts once above."""
    from repro_torch.core import scatter
    plane, width, idx, src = _scatter_inputs(kind, np.random.default_rng(0))
    view = (lambda t: t[:, :width]) if width else (lambda t: t)
    want = plane.clone()
    view(want).index_add_(0, idx, src)
    small = idx.numel() <= scatter.GROUP_MAX
    outs = []
    for _ in range(2):
        g = plane.to(cuda)
        before = (scatter.LAUNCHES, scatter.GROUP_LAUNCHES,
                  scatter.RUN_LAUNCHES, scatter.SORTS)
        got = scatter.index_add_det_(view(g), idx.to(cuda), src.to(cuda))
        torch.cuda.synchronize()
        after = (scatter.LAUNCHES, scatter.GROUP_LAUNCHES,
                 scatter.RUN_LAUNCHES, scatter.SORTS)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1, 0, 0] if small else [1, 0, 1, 1])
        assert got.data_ptr() == g.data_ptr()
        outs.append(g.cpu())
    assert torch.equal(outs[0], want), float((outs[0] - want).abs().max())
    assert torch.equal(outs[0], outs[1])
    g = plane.to(cuda)
    plan = scatter.segment_plan(idx.to(cuda))
    before = (scatter.LAUNCHES, scatter.GROUP_LAUNCHES, scatter.SORTS)
    scatter.index_add_det_(view(g), idx.to(cuda), src.to(cuda), plan=plan)
    assert torch.equal(g.cpu(), want)
    scatter.index_add_det_(view(g), idx.to(cuda), -src.to(cuda), plan=plan)
    assert (scatter.LAUNCHES - before[0], scatter.GROUP_LAUNCHES - before[1],
            scatter.SORTS - before[2]) == (2, 0, 0)
    again = want.clone()
    view(again).index_add_(0, idx, -src)
    assert torch.equal(g.cpu(), again)


@pytest.mark.parametrize("kind", _SCATTER_KINDS)
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_segment_plan_on_card_equals_plain(cuda, kind, dtype):
    """The grouping kernel's (or, past `GROUP_MAX`, the sort's and the
    run-table kernel's) positions, run ids, starts, lengths and long runs
    equal the plain stable sort + `unique_consecutive`'s, from int64 and
    int32 ids; the plain add on that plan equals `index_add_`."""
    from repro_torch.core import scatter
    plane, width, idx, src = _scatter_inputs(kind, np.random.default_rng(1))
    idx = idx.to(dtype)
    got = scatter.segment_plan(idx.to(cuda))
    want = scatter.segment_plan_plain(idx)
    torch.cuda.synchronize()
    assert got.n == want.n == idx.numel()
    assert torch.equal(got.order.cpu(), want.order)
    for a, b in zip(got.table(), want.table()):
        assert torch.equal(a.cpu(), b)
    if idx.numel() <= 4096 and plane.numel() <= 10 ** 6:
        dst = plane[:, :width] if width else plane
        assert torch.equal(scatter.segment_add_plain(dst.clone(), src, want),
                           dst.clone().index_add_(0, idx.long(), src))


def test_segment_plans_group_several_vectors_in_one_launch(cuda):
    """`segment_plans` groups two vectors of at most `GROUP_MAX` ids in
    one launch (one block each), sorts a larger one, refuses a third
    vector, and each plan equals its vector's own plain plan; on the CPU
    every plan is None."""
    from repro_torch.core import scatter
    rng = np.random.default_rng(2)
    pairs = [[torch.tensor(_zipf_ids(rng, n, hi)) for n, hi in pair]
             for pair in (((512, 700000), (512, 30150)),
                          ((4096, 30150), (1, 3)),
                          ((8192, 5000), (9000, 100)), ((0, 1),))]
    before = (scatter.GROUP_LAUNCHES, scatter.RUN_LAUNCHES, scatter.SORTS)
    plans = [scatter.segment_plans(*(i.to(cuda) for i in pair))
             for pair in pairs]
    torch.cuda.synchronize()
    assert (scatter.GROUP_LAUNCHES - before[0], scatter.RUN_LAUNCHES
            - before[1], scatter.SORTS - before[2]) == (4, 1, 1)
    for idx, got in zip(sum(pairs, []), sum(plans, [])):
        want = scatter.segment_plan_plain(idx)
        assert got.n == want.n
        assert torch.equal(got.order.cpu(), want.order)
        for a, b in zip(got.table(), want.table()):
            assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="at most 2"):
        scatter.segment_plans(*(i.to(cuda) for i in pairs[0] + pairs[3]))
    assert scatter.segment_plans(*pairs[0]) == [None, None]


def test_segment_add_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.core import scatter
    idx = torch.zeros(4, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        scatter.index_add_det_(torch.zeros(3, 2, dtype=torch.float64,
                                           device=cuda), idx,
                               torch.zeros(4, 2, dtype=torch.float64,
                                           device=cuda))
    with pytest.raises(ValueError, match="does not match"):
        scatter.index_add_det_(torch.zeros(3, 2, device=cuda), idx,
                               torch.zeros(4, 3, device=cuda))
    with pytest.raises(ValueError, match="adjacent columns"):
        scatter.index_add_det_(torch.zeros(2, 3, device=cuda).T, idx[:3],
                               torch.zeros(3, 2, device=cuda))


def test_encode_on_card_is_reproducible(cuda):
    """Two encodes on the card give the same accumulators bit for bit, and
    the CPU's (the segment sum adds in COO order on both)."""
    params, sp, sigs, _ = _state()
    cfg = simlsh.SimLSHConfig(G=8, p=2, q=10)
    sp_g = sp.to(cuda)
    runs = [simlsh.encode(sp_g, cfg, prng.PRNGKey(0),
                          return_accumulators=True) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0].cpu(), sigs)
    _, S_cpu = simlsh.encode(sp, cfg, prng.PRNGKey(0),
                             return_accumulators=True)
    assert torch.equal(runs[0][1].cpu(), S_cpu)


def test_online_update_on_card_is_bit_identical_run_to_run(cuda):
    from repro_torch.core import online
    from repro_torch.core.sgd import Hyper
    from repro_torch.core import scatter
    st, lsh = _online_state()
    M2, N2 = st.M + 40, st.N + 12
    d = _online_delta(st, M2, N2)
    gpu_st = _state_to(st, cuda)
    before = scatter.LAUNCHES
    runs = [online.online_update(gpu_st, *d, lsh, Hyper(), prng.PRNGKey(9),
                                 M_new=M2, N_new=N2, K=8, epochs=2)
            for _ in range(2)]
    assert scatter.LAUNCHES > before
    for f in ("U", "b", "V", "bh", "W", "C"):
        assert torch.equal(getattr(runs[0].params, f),
                           getattr(runs[1].params, f)), f
    assert torch.equal(runs[0].S, runs[1].S)
    assert torch.equal(runs[0].JK, runs[1].JK)


def test_wal_recovery_on_card_is_bit_identical(cuda, tmp_path):
    """Crash on the third update after logging it; `recover` (checkpoint
    at 2, replay of 3) equals an uninterrupted updater leaf for leaf."""
    from repro_torch.core.sgd import Hyper
    from repro_torch.resil import OnlineUpdater, faults, wal
    from repro_torch.resil.faults import FaultSpec, InjectedFault
    st, lsh = _online_state()
    st = _state_to(st, cuda)
    kw = dict(K=8, epochs=1, batch=512, ckpt_every=2)

    def drive(up, crash_at=None):
        M, N = st.M, st.N
        for i in range(3):
            M, N = M + 6, N + 3
            d = _online_delta(up.state, M, N, n=300, seed=40 + i)
            if i == crash_at:
                with faults.injected({"online.update":
                                      FaultSpec(at_calls=(0,))}):
                    with pytest.raises(InjectedFault):
                        up.update(*d, prng.PRNGKey(i), M_new=M, N_new=N)
                return
            up.update(*d, prng.PRNGKey(i), M_new=M, N_new=N)

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else torch.tensor(x)

    crashed = OnlineUpdater(st, lsh, Hyper(), root=str(tmp_path / "a"), **kw)
    drive(crashed, crash_at=2)
    rec = OnlineUpdater.recover(str(tmp_path / "a"), lsh, Hyper(),
                                device=cuda, **kw)
    whole = OnlineUpdater(st, lsh, Hyper(), root=str(tmp_path / "b"), **kw)
    drive(whole)
    assert rec.seq == whole.seq == 3
    assert rec.state.params.U.device.type == "cuda"
    ta, tb = wal.state_tree(rec.state), wal.state_tree(whole.state)
    for k in ta:
        assert torch.equal(host(ta[k]), host(tb[k])), k


def test_background_rebuild_swaps_on_card(cuda):
    """An overflow hands the rebuild to the worker's stream; flushes go on
    against index v; the validated v+1 swaps in at the next flush and its
    flushes equal the plain versions (ids bit for bit)."""
    params, sp, sigs, index = _state()
    cfg = ServeConfig(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
                      n_popular=16, tile_b=8, band_budget=256)
    svc = RecsysService(params, index, sp, cfg, device=cuda).warmup()
    full = torch.cat([sigs, sigs[:, :40]], dim=1).to(cuda)
    ids = torch.arange(1500, 1540, dtype=torch.int32, device=cuda)
    svc.ingest(full[:, 1500:], ids, full_sigs=full)          # 40 > tail 32
    assert svc.stats()["index_stale"] and svc.index.n_items == 1500
    users = np.arange(0, 960, 15, dtype=np.int32)
    svc.submit(users)                     # served on v while v+1 builds
    svc._rebuilder.join(60)
    svc.submit(users)                     # the swap lands here
    svc.flush()
    assert svc.index.n_items == 1540 and not svc.stats()["index_stale"]
    assert svc.index.device.type == "cuda"
    assert svc.obs.counter("serve.rebuild.swaps") == 1
    assert svc.stats()["fallbacks"] == 0
    want = build_index(full, tail_cap=32, device=cuda)
    for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi"):
        assert torch.equal(getattr(svc.index, f), getattr(want, f)), f
    res = svc.take_results()
    assert len(res) == 2
    kw = dict(n_seeds=8, cap=8, C=128, window=64, tail_scan=False, topn=10,
              tile_b=8)
    s_ref, i_ref = recommend_walked_kernel(
        svc.planes, svc.index, svc.sp, torch.from_numpy(users).to(cuda),
        svc.popular, svc._flat_ids(), impl="ref", **kw)
    assert np.array_equal(res[1][2], i_ref.cpu().numpy())
    np.testing.assert_allclose(res[1][1], s_ref.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("field", ["sorted_ids", "bucket_hi", "sorted_sigs"])
def test_validate_index_on_card_says_what_it_says_on_the_cpu(cuda, field):
    """The checks run on the index's device: a clean index passes and a
    corrupted one gets the CPU's problem strings."""
    from repro_torch.resil import validate_index
    _, _, _, index = _state()
    a = getattr(index, field).clone()
    if field == "sorted_ids":
        a[0, 0] = a[0, 1]
    elif field == "bucket_hi":
        a[2] = 0
    else:
        a = a.flip(1).contiguous()
    bad = dataclasses.replace(index, **{field: a})
    assert validate_index(index.to(cuda)) == validate_index(index) == []
    want = validate_index(bad)
    assert want and validate_index(bad.to(cuda)) == want


# ------------------------------------------------- the always-on loop

_LOOP_REF = {}


def _loop_on_card(root, cuda):
    """`tests/test_resil.py`'s loop (its `LoopConfig` and `ServeConfig`)
    on `_online_state`'s state on the card."""
    from repro_torch.core.sgd import Hyper
    from repro_torch.loop import LoopConfig, OnlineLoop
    from repro_torch.resil import OnlineUpdater
    st, lsh = _online_state()
    st = _state_to(st, cuda)
    cfg = LoopConfig(serve_flushes=2, micro_epochs=1, micro_batch=512,
                     deltas_per_slice=2, max_lag=2, ckpt_every=2,
                     drift_every=2, drift_window=4, tail_cap=16, seed=0)
    serve = ServeConfig(topn=5, micro_batch=8, C=32, n_seeds=4, cap=8,
                        n_popular=16)
    up = OnlineUpdater(st, lsh, Hyper(), root=str(root), K=8, epochs=1,
                       batch=512)
    svc = OnlineLoop.build_service(st, serve, tail_cap=cfg.tail_cap)
    hold = tuple(a[:200] for a in (st.sp.rows, st.sp.cols, st.sp.vals))
    return OnlineLoop(up, svc, cfg, holdout=hold), st, lsh, cfg, serve


def _drive_on_card(loop, kill_site=None, kill_call=0):
    """Six slices of `test_resil.py`'s schedule; → (killed, {seq: state
    tree on the host})."""
    from repro_torch.resil import faults, wal
    from repro_torch.resil.faults import FaultSpec, InjectedFault
    M, N = loop.state.M, loop.state.N
    snaps = {}
    plan = (faults.install(faults.FaultPlan(
        {kill_site: FaultSpec(at_calls=(kill_call,))})) if kill_site
        else None)
    try:
        for s in range(6):
            rng = np.random.default_rng(500 + s)
            loop.svc.submit(rng.integers(0, M, 16).astype(np.int32))
            if s % 2 == 0:
                M, N = M + 4, N + 2
                d = _online_delta(loop.state, M, N, n=250, seed=1000 + s)
                loop.offer_delta(*d, prng.PRNGKey(70 + s), M_new=M, N_new=N)
            try:
                loop.run_slice()
            except InjectedFault:
                return True, snaps
            snaps[loop.updater.seq] = {
                k: (v.cpu() if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v)))
                for k, v in wal.state_tree(loop.state).items()}
        return False, snaps
    finally:
        if plan is not None:
            faults.uninstall()


def _loop_reference(cuda, root):
    if "snaps" not in _LOOP_REF:
        loop, *_ = _loop_on_card(root, cuda)
        killed, snaps = _drive_on_card(loop)
        assert not killed
        assert loop.state.params.U.device.type == "cuda"
        assert loop.svc.stats()["dropped"] == 0
        _LOOP_REF["snaps"] = snaps
    return _LOOP_REF["snaps"]


def test_loop_on_card_run_twice_is_bit_identical(cuda, tmp_path):
    """Six slices (ΔΩ, micro-epochs, drift probes, publishes, checkpoints)
    on the card, twice in fresh roots: every state, by seq, bit for bit."""
    ref = _loop_reference(cuda, tmp_path / "ref")
    loop, *_ = _loop_on_card(tmp_path / "again", cuda)
    killed, snaps = _drive_on_card(loop)
    assert not killed and sorted(snaps) == sorted(ref)
    for q in ref:
        for k in ref[q]:
            assert torch.equal(snaps[q][k], ref[q][k]), (q, k)


@pytest.mark.parametrize("site,call", [("loop.slice", 3), ("loop.ckpt", 1),
                                       ("loop.drift", 1)])
def test_loop_kill_at_each_site_recovers_bit_identically_on_card(
        cuda, tmp_path, site, call):
    from repro_torch.core.sgd import Hyper
    from repro_torch.loop import OnlineLoop
    from repro_torch.resil import wal
    ref = _loop_reference(cuda, tmp_path / "ref")
    loop, st0, lsh, cfg, serve = _loop_on_card(tmp_path / "killed", cuda)
    killed, _ = _drive_on_card(loop, kill_site=site, kill_call=call)
    assert killed
    del loop
    rec = OnlineLoop.recover(str(tmp_path / "killed"), lsh, Hyper(), serve,
                             K=8, epochs=1, batch=512, cfg=cfg,
                             base_state=st0)
    assert rec.state.params.U.device.type == "cuda"
    want = ref[rec.updater.seq]
    for k, v in wal.state_tree(rec.state).items():
        got = v.cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        assert torch.equal(got, want[k]), (site, k)
    rec.svc.submit(np.arange(16, dtype=np.int32))
    rec.run_slice()
    assert rec.svc.stats()["dropped"] == 0


# ------------------------------------------------- the fit's comparators

def _comparator_data(M=2000, N=500, nnz=20_000, seed=0):
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=M, N=N, nnz=nnz)
    rows, cols, vals, _ = synthetic.generate(spec, seed=seed)
    return spec, rows, cols, vals


def test_gsm_topk_on_card_matches_cpu(cuda):
    """Ids equal to the CPU run's except where two scores agree within
    1e-5 (the two devices' matmuls round differently)."""
    from repro_torch.core import gsm
    spec, rows, cols, vals = _comparator_data()
    sp = from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    cpu = gsm.gsm_topk(sp, K=16).numpy().astype(np.int64)
    got = gsm.gsm_topk(sp.to(cuda), K=16)
    assert got.device.type == "cuda"
    got = got.cpu().numpy().astype(np.int64)
    X = np.zeros((spec.M, spec.N))
    B = np.zeros((spec.M, spec.N))
    X[rows, cols], B[rows, cols] = vals, 1.0
    Xc = (X - X.sum(0) / np.maximum(B.sum(0), 1.0)) * B
    X2 = Xc * Xc
    n = B.T @ B
    S = n / (n + 100.0) * (Xc.T @ Xc) / np.sqrt(
        np.maximum((X2.T @ B) * (B.T @ X2), 1e-12))
    np.fill_diagonal(S, -np.inf)
    differ = got != cpu
    s_got = np.take_along_axis(S, got, axis=1)
    s_cpu = np.take_along_axis(S, cpu, axis=1)
    assert (np.abs(s_got - s_cpu)[differ] <= 1e-5).all()
    assert differ.sum() <= 0.01 * differ.size


def test_comparator_signatures_on_card_equal_cpu(cuda):
    """minHash and random-K are threefry draws and an order-free minimum;
    RP_cos sums through `index_add_det_`: all bit-equal to the CPU, and
    run to run."""
    from repro_torch.core import baselines
    spec, rows, cols, vals = _comparator_data()
    sp = from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    cfg = simlsh.SimLSHConfig(G=8, p=3, q=6)
    key = prng.PRNGKey(11)
    for fn in (baselines.minhash_signatures, baselines.rp_cos_signatures):
        want = fn(sp, cfg, key)
        runs = [fn(sp.to(cuda), cfg, key) for _ in range(2)]
        assert runs[0].device.type == "cuda"
        assert torch.equal(runs[0].cpu(), want), fn.__name__
        assert torch.equal(runs[0], runs[1]), fn.__name__
    got = baselines.rand_topk(key, spec.N, 16, device=cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), baselines.rand_topk(key, spec.N, 16))


@pytest.mark.parametrize("method", ["rp_cos", "minhash", "rand", "gsm"])
def test_fit_with_comparator_on_card_launches_culsh_per_cf_step(cuda,
                                                                 method):
    from repro_torch.train.trainer import FitConfig, fit
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=90,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    cfg = FitConfig(F=16, K=8, epochs=2, cf_batch=64, use_kernels=True,
                    method=method,
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16))
    before = sgd_kernel.CULSH_LAUNCHES
    res = fit(tr, te, (spec.M, spec.N), cfg)
    assert (sgd_kernel.CULSH_LAUNCHES - before
            == res.schedule_stats["nb_cf"] * cfg.epochs)
    assert res.JK.device.type == "cuda"
    cpu = fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
    if method != "gsm":
        assert torch.equal(res.JK.cpu(), cpu.JK)
    for (_, _, a), (_, _, b) in zip(res.history, cpu.history):
        assert abs(a - b) < 1e-4


# ------------------------------------ the legacy and plain walk serving paths

def _legacy_state(tail):
    """`_state()` with its J^K (`benchmarks/bench_serve.py`'s recipe) and,
    with ``tail``, twenty cloned items in the index tail."""
    from repro_torch.core import topk
    params, sp, sigs, index = _state()
    JK = topk.topk_from_signatures(sigs, prng.fold_in(prng.PRNGKey(0), 1),
                                   K=16, band_cap=16)
    if tail:
        index = insert(index, sigs[:, 5:25],
                       torch.arange(1500, 1520, dtype=torch.int32))
    return params, sp, index, JK


LEGACY_CFG = ServeConfig(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
                         n_popular=16, tile_b=8, band_budget=0,
                         background_rebuild=False)


def test_legacy_service_on_card_launches_the_scorer_per_flush(cuda):
    """``band_budget=0`` on the card: one `candidate_score` launch a flush
    or warm-up and no `lsh_retrieve`; every flush within 1e-5 of
    `recommend_candidates(impl="ref")` on the same users, and of the
    CPU service."""
    from repro_torch.serve import recommend_candidates
    params, sp, index, JK = _legacy_state(tail=True)
    users = np.arange(0, 960, 3, dtype=np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        svc = RecsysService(params, index, sp, LEGACY_CFG, JK=JK, device=dev)
        before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
        svc.warmup()
        svc.submit(users)
        svc.flush()
        res = svc.take_results()
        n = (lsh_kernel.LAUNCHES - before[0], score_kernel.LAUNCHES - before[1])
        assert n == ((0, svc.stats()["batches"] + 1) if dev == "cuda"
                     else (0, 0))
        out[dev] = res
        if dev == "cuda":
            for u, s, i in res:
                want = recommend_candidates(
                    svc.planes, svc.index, svc.sp,
                    torch.from_numpy(u).to(cuda), svc.JK, svc.popular,
                    n_seeds=8, cap=8, C=128, window=64, pool_width=0,
                    fold_mates=True, tail_scan=True, topn=10, tile_b=8,
                    impl="ref")
                assert_topn_close(s, i, *want)
    for (_, s, i), (_, s_c, i_c) in zip(out["cuda"], out["cpu"]):
        assert_topn_close(s, i, s_c, i_c)


@pytest.mark.parametrize("tail", [False, True])
def test_retrieval_on_card_is_bit_equal_to_cpu(cuda, tail):
    """The legacy and plain-walk retrieval stages are integer work: the
    card's ids equal the CPU's bit for bit."""
    from repro_torch.serve import (retrieve_for_items, retrieve_for_users,
                                   walk_candidates)
    params, sp, index, JK = _legacy_state(tail)
    users = torch.arange(0, 960, 7, dtype=torch.int32)
    popular = torch.arange(16, dtype=torch.int32) * 50
    gidx, gsp = index.to(cuda), sp.to(cuda)
    for pool_width in (0, 96):
        kw = dict(n_seeds=8, cap=8, C=128, popular=popular,
                  pool_width=pool_width, tail_scan=tail)
        got = retrieve_for_users(gidx, gsp, users.to(cuda), JK=JK.to(cuda),
                                 **dict(kw, popular=popular.to(cuda)))
        assert torch.equal(got.cpu(), retrieve_for_users(index, sp, users,
                                                         JK=JK, **kw))
    for budget in (64, 512):
        got = walk_candidates(gidx, gsp, users.to(cuda), n_seeds=8, cap=8,
                              budget=budget)
        want = walk_candidates(index, sp, users, n_seeds=8, cap=8,
                               budget=budget)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    items = torch.arange(0, 1520, 11, dtype=torch.int32)
    assert torch.equal(
        retrieve_for_items(gidx, items.to(cuda), cap=8, C=64).cpu(),
        retrieve_for_items(index, items, cap=8, C=64))


@pytest.mark.parametrize("tail_k", [0, 32])
def test_recommend_walked_on_card_matches_cpu(cuda, tail_k):
    """The plain walk path launches no kernel; its answers on the card
    are within 1e-5 of the CPU's."""
    from repro_torch.core.model import pack_serve_planes
    from repro_torch.serve import popular_shortlist, recommend_walked
    params, sp, index, _ = _legacy_state(tail=bool(tail_k))
    users = torch.arange(0, 960, 5, dtype=torch.int32)
    kw = dict(n_seeds=8, cap=8, budget=256, window=64, tail_k=tail_k,
              topn=10, tile_b=16)
    out = {}
    for dev in ("cpu", "cuda"):
        p = params.to(dev)
        before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
        out[dev] = recommend_walked(pack_serve_planes(p), index.to(dev),
                                    sp.to(dev), users.to(dev),
                                    popular_shortlist(p, 16), **kw)
        assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before
    assert_topn_close(*out["cuda"], *out["cpu"])


@pytest.mark.parametrize("knob", [dict(), dict(impl="ref"),
                                  dict(band_budget=0)])
def test_profile_flush_on_card_staged_equals_fused(cuda, knob):
    params, sp, index, JK = _legacy_state(tail=True)
    cfg = dataclasses.replace(LEGACY_CFG, **{"band_budget": 256, **knob})
    svc = RecsysService(params, index, sp, cfg, JK=JK, device=cuda).warmup()
    users = np.arange(0, 640, 10, dtype=np.int32)
    svc.submit(users)
    svc.flush()
    _, s, i = svc.take_results()[0]
    secs = svc.profile_flush(users)
    assert secs["serve.flush"] >= secs["serve.flush.score"] > 0
    np.testing.assert_array_equal(svc.profiled[1].cpu().numpy(), i)
    np.testing.assert_allclose(svc.profiled[0].cpu().numpy(), s, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the multi-device tiers on four logical shards of the card
# ---------------------------------------------------------------------------

SHARD_BENCH = dict(topn=10, micro_batch=64, C=512, n_seeds=16, cap=8,
                   n_popular=64, tile_b=16, band_budget=512)
SHARD_EXACT = dict(topn=10, micro_batch=64, n_seeds=8, cap=4096,
                   band_budget=16384, shard_budget=16384, n_popular=0,
                   use_jk=False)


def _sharded(params, index, sp, dev, **kw):
    return RecsysService(params, index, sp, ServeConfig(**kw), device=dev)


def test_sharded_flush_on_card_equals_cpu_and_launches_nothing(
        cuda, monkeypatch):
    from repro_torch.launch.mesh import LOGICAL_DEVICES
    monkeypatch.setenv(LOGICAL_DEVICES, "4")
    params, sp, sigs, _ = _state()
    index = build_index(sigs, tail_cap=0, device="cpu")
    users = torch.arange(0, 960, 15, dtype=torch.int32)
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    svc = _sharded(params, index, sp, cuda, **SHARD_BENCH, shards=4)
    assert svc.stats()["shards"] == 4
    assert {d.type for d in svc._shard_state.mesh.devices} == {"cuda"}
    got = svc._recommend(users.to(cuda))
    torch.cuda.synchronize()
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before
    want = _sharded(params, index, sp, "cpu", **SHARD_BENCH,
                    shards=4)._recommend(users)
    assert_topn_close(*got, *want)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_regime1_on_card_equals_single_device_walk(cuda, monkeypatch,
                                                           D):
    from repro_torch.launch.mesh import LOGICAL_DEVICES
    monkeypatch.setenv(LOGICAL_DEVICES, "4")
    params, sp, sigs, _ = _state()
    index = build_index(sigs, tail_cap=0, device="cpu")
    users = torch.arange(0, 960, 15, dtype=torch.int32).to(cuda)
    s_a, i_a = _sharded(params, index, sp, cuda, **SHARD_EXACT,
                        shards=D)._recommend(users)
    s_b, i_b = _sharded(params, index, sp, cuda, **SHARD_EXACT,
                        impl="ref")._recommend(users)
    for u in range(users.shape[0]):
        ra, rb = i_a[u] != SENTINEL, i_b[u] != SENTINEL
        assert set(i_a[u][ra].tolist()) == set(i_b[u][rb].tolist()), u
        np.testing.assert_allclose(np.sort(s_a[u][ra].cpu().numpy()),
                                   np.sort(s_b[u][rb].cpu().numpy()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mf_only", [False, True])
def test_mesh_shard_tier_on_card_equals_replay(cuda, monkeypatch, mf_only):
    """Two epochs of a four-shard schedule through the mesh (four logical
    shards of the card) and through the one-device replay, from one
    state: within 1e-5 in every leaf."""
    from repro_torch.launch.mesh import LOGICAL_DEVICES, make_shard_mesh
    monkeypatch.setenv(LOGICAL_DEVICES, "4")
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=240, N=96,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    sp = from_coo(rows, cols, vals, (spec.M, spec.N), device=cuda)
    rng = np.random.default_rng(0)
    JK = torch.tensor(rng.integers(0, spec.N, (spec.N, 8)),
                      dtype=torch.int32, device=cuda)
    sched = sparse.conflict_free_schedule(
        sp.rows.cpu().numpy(), sp.cols.cpu().numpy(), batch=64, M=spec.M,
        N=spec.N, shards=4, seed=0)
    sd = model.build_scheduled_data(sp, JK, sched, mf_only=mf_only)
    shd = model.build_shard_data(sp, JK, sched, mf_only=mf_only)
    p0 = model.remap_params(model.init_from_data(prng.PRNGKey(0), sp, 8, 8),
                            sched)
    out = []
    for mesh in (make_shard_mesh(4, cuda), None):
        pp = model.pack_params(p0)
        for ep in range(2):
            sgd.train_epoch_scheduled(pp, sd, sched,
                                      prng.fold_in(prng.PRNGKey(1), ep), ep,
                                      sgd.Hyper(), shd=shd, mf_only=mf_only,
                                      use_kernels=True, mesh=mesh)
        torch.cuda.synchronize()
        out.append(pp)
    for a, b in ((out[0].row, out[1].row), (out[0].col, out[1].col)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# routing on the card, NCF, the bce fit, the examples and dense LM serving
# ---------------------------------------------------------------------------

def test_default_service_on_card_runs_the_kernel_walk(cuda):
    """``impl="auto"`` resolves to the kernels on the card (one launch of
    each a flush); ``interpret=True`` runs their plain versions there,
    launching nothing, with the same ids."""
    params, sp, _, index = _state()
    kw = dict(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
              n_popular=16, tile_b=8, band_budget=256)
    users = np.arange(0, 960, 3, dtype=np.int32)
    out = {}
    for interp in (None, True):
        svc = RecsysService(params, index, sp,
                            ServeConfig(interpret=interp, **kw),
                            device=cuda)
        assert svc.cfg.kernel_impl(cuda) == ("cuda" if interp is None
                                             else "ref")
        before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
        svc.submit(users)
        svc.flush()
        res = svc.take_results()
        n = (lsh_kernel.LAUNCHES - before[0],
             score_kernel.LAUNCHES - before[1])
        assert n == ((len(res), len(res)) if interp is None else (0, 0))
        out[interp] = np.concatenate([r[2] for r in res])
    assert (out[None] == out[True]).mean() > 0.99


def _implicit(M=400, N=100, per_user=8, seed=0):
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(M), per_user).astype(np.int32)
    items = ((users * 7 + rng.integers(0, 6, len(users))) % N).astype(
        np.int32)
    _, uq = np.unique(users.astype(np.int64) * N + items, return_index=True)
    return users[uq], items[uq], M, N


def test_ncf_first_step_on_card_matches_cpu(cuda):
    """Each NCF model's gradients on the card within 1e-5 of the CPU's,
    relative to each leaf's largest entry, and the Adam update of the same gradients within 1e-6."""
    from repro_torch import tree as T
    from repro_torch.core import ncf
    users, items, M, N = _implicit()
    negs = np.random.default_rng(1).integers(0, N, len(users))
    i = torch.from_numpy(np.concatenate([users, users]))
    j = torch.from_numpy(np.concatenate([items, negs]).astype(np.int32))
    y = torch.cat([torch.ones(len(users)), torch.zeros(len(users))])
    for kind in ("gmf", "mlp", "neumf"):
        c = ncf.NCFConfig(M=M, N=N, F=16, mlp_layers=(32, 16), kind=kind)
        p = ncf.init(c, prng.PRNGKey(0), device="cpu")
        pc = T.tree_map(lambda a: a.to(cuda), p)
        g = ncf.grads(p, c, i, j, y)
        gc = ncf.grads(pc, c, i.to(cuda), j.to(cuda), y.to(cuda))
        for a, b in zip(T.leaves(gc), T.leaves(g)):
            scale = float(b.abs().max())          # each leaf's own scale
            assert scale > 0
            assert float((a.cpu() - b).abs().max()) <= (
                1e-5 * scale + 4 * float(np.spacing(np.float32(scale))))
        z = lambda t: T.tree_map(torch.zeros_like, t)
        with torch.no_grad():
            up_c = ncf.adam_update(pc, z(pc), z(pc), gc, 1, lr=2e-2)
            up = ncf.adam_update(p, z(p), z(p),
                                 T.tree_map(lambda a: a.cpu(), gc), 1,
                                 lr=2e-2)
        for tc, th in zip(up_c, up):
            for a, b in zip(T.leaves(tc), T.leaves(th)):
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                           rtol=1e-6, atol=1e-6)
        users_t = torch.arange(M, dtype=torch.int32)
        cands = torch.from_numpy(np.random.default_rng(2).integers(
            0, N, (M, 50)).astype(np.int32))
        pos = (users_t * 7) % N
        hits = lambda hr: round(float(hr) * M)        # the mean's last bit
        assert hits(ncf.hit_ratio(pc, c, users_t.to(cuda), pos.to(cuda),
                                  cands.to(cuda))) == hits(
            ncf.hit_ratio(p, c, users_t, pos, cands))


def test_bce_fit_on_card_launches_culsh_sgd_and_matches_cpu(cuda):
    """Table 10's implicit fit (``loss="bce"``) on the card: one
    `culsh_sgd` launch a conflict-free step an epoch, every parameter
    within 1e-4 of the CPU fit's after 3 epochs."""
    from repro_torch.core.sgd import Hyper
    from repro_torch.train.trainer import FitConfig, fit
    users, items, M, N = _implicit()
    negs = np.random.default_rng(1).integers(0, N, 3 * len(users))
    tr = (np.concatenate([users] * 4),
          np.concatenate([items, negs]).astype(np.int32),
          np.concatenate([np.ones(len(users)),
                          np.zeros(3 * len(users))]).astype(np.float32))
    te = (users[:50], items[:50], np.ones(50, np.float32))
    cfg = FitConfig(F=16, K=8, epochs=3, batch=2048, method="simlsh",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, psi_pow=1.0),
                    hp=Hyper(a_u=0.2, a_v=0.2, a_b=0.1, a_bh=0.1, beta=0.02),
                    loss="bce", eval_every=0, use_kernels=True, shards=1)
    before = sgd_kernel.CULSH_LAUNCHES
    card = fit(tr, te, (M, N), cfg, device=cuda)
    n = sgd_kernel.CULSH_LAUNCHES - before
    cpu = fit(tr, te, (M, N), cfg, device="cpu")
    assert n == card.schedule_stats["nb_cf"] * 3 > 0
    for f in ("U", "V", "b", "bh", "W", "C"):
        np.testing.assert_allclose(getattr(card.params, f).cpu().numpy(),
                                   getattr(cpu.params, f).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def _example(name):
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / (
        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_on_card_launch_their_kernels(cuda, capsys):
    small = ["--M", "600", "--N", "100", "--nnz", "12000", "--epochs", "2"]
    before = sgd_kernel.CULSH_LAUNCHES
    quick = _example("torch_quickstart").main(small)
    assert sgd_kernel.CULSH_LAUNCHES > before and np.isfinite(quick["rmse"])
    cpu = _example("torch_quickstart").main(["--device", "cpu", *small])
    assert abs(quick["rmse"] - cpu["rmse"]) < 1e-3
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    got = _example("torch_serve_recsys").cli([*small, "--report"])
    assert lsh_kernel.LAUNCHES > before[0]
    assert score_kernel.LAUNCHES > before[1]
    assert got["recall"] > 0.5 and got["fallbacks"] == 0
    # --report held the kernel walk against its plain versions
    assert got["walk_vs_plain"]["users"] == 256


def test_lm_on_card_matches_cpu_and_its_cache(cuda):
    """Reduced llama3-8b on the card: at float32 the greedy tokens of
    `serve` equal the CPU's; in bfloat16 the prefill's last logits equal
    a token-by-token decode's within 16·2⁻⁸ of their rms."""
    from repro_torch.configs import base as CB
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get("llama3-8b")),
                              dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict)
              else v.to(cuda)) for k, v in p.items()}
    got, st = serve(cfg, batch=2, prompt_len=16, gen=8, device=cuda,
                    params=pc, log=lambda *_: None)
    want, _ = serve(cfg, batch=2, prompt_len=16, gen=8, device="cpu",
                    params=p, log=lambda *_: None)
    assert torch.equal(got.cpu(), want) and st["peak_mb"] > 0
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    toks = torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    pre, _ = steps.make_prefill(bf)(pc, {"tokens": toks})
    cache = steps.init_cache(bf, 2, 24, device=cuda)
    dec = steps.make_decode_step(bf)
    for t in range(24):
        lg, cache = dec(pc, cache, toks[:, t:t + 1])
    rms = float(pre.pow(2).mean().sqrt())
    assert float((lg[:, 0] - pre).abs().max()) <= 16 * 2 ** -8 * rms


def test_lm_train_step_on_card_matches_cpu(cuda):
    """Reduced qwen3-0.6b at float32: the loss on the card within 1e-5 of
    the CPU's, each gradient leaf within 1e-5 of its own max |g| (plus 4
    ulp), and one Adam update of the same gradients within 1e-6."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get("qwen3-0.6b")),
                              dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                          generator=g) for k in ("tokens", "labels")}
    lc, gc = steps.value_and_grad(cfg, pc, {k: v.to(cuda)
                                            for k, v in b.items()})
    l0, g0 = steps.value_and_grad(cfg, p, b)
    assert abs(float(lc) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, w in zip(T.leaves(gc), T.leaves(g0)):
        scale = float(w.abs().max())
        assert scale > 1e-4
        assert float((a.cpu() - w).abs().max()) <= 1e-5 * scale + 4 * float(
            np.spacing(np.float32(scale)))
    grads = T.tree_map(lambda t: t.cpu(), gc)
    on_cpu = steps.adam_update(cfg, T.tree_map(torch.clone, p), grads,
                               steps.init_opt(cfg, p))
    on_card = steps.adam_update(cfg, pc, T.tree_map(lambda t: t.to(cuda),
                                                    grads),
                                steps.init_opt(cfg, pc))
    for a, w in zip(T.leaves(on_card[:2]), T.leaves(on_cpu[:2])):
        assert float((a.cpu().double() - w.double()).abs().max()) <= 1e-6


def test_lm_gather_gradient_is_bit_reproducible(cuda):
    """The simLSH arm's candidate and label gathers, whose ids repeat,
    backward through `segment_add`: two runs give bit-equal gradients,
    and the kernel launched."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.core import scatter
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get("qwen3-0.6b")),
                              dtype="float32", lsh_softmax=True)
    p = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1, device=cuda)
    g = torch.Generator().manual_seed(1)
    b = {k: torch.randint(0, 64, (4, 32), dtype=torch.int32,
                          generator=g).to(cuda)
         for k in ("tokens", "labels")}
    b["cands"] = torch.randint(0, 96, (256,), dtype=torch.int32,
                               generator=g).to(cuda)
    before = scatter.LAUNCHES
    runs = [steps.value_and_grad(cfg, p, b) for _ in range(2)]
    assert scatter.LAUNCHES >= before + 4
    assert torch.equal(runs[0][0], runs[1][0])
    for a, w in zip(T.leaves(runs[0][1]), T.leaves(runs[1][1])):
        assert torch.equal(a, w)


def test_lm_checkpoint_round_trip_on_card(cuda, tmp_path):
    """`launch/train.py`'s ``(params, opt)`` tree saved from the card and
    restored onto it, leaf for leaf; the loop resumes from it."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch.train import train_loop
    from repro_torch.train import checkpoint as ckpt
    cfg = CB.reduced(CB.get("qwen1.5-0.5b"))
    d = str(tmp_path)
    p, opt, losses = train_loop(cfg, steps_n=3, batch=2, seq=16, ckpt_dir=d,
                                device=cuda, log=lambda *_: None)
    assert len(losses) == 3 and int(opt["count"]) == 3
    got, step = ckpt.restore(d, (p, opt))
    assert step == 3
    for a, w in zip(T.leaves(got), T.leaves((p, opt))):
        assert a.device.type == "cuda" and a.dtype == w.dtype
        assert torch.equal(a, w)
    logs = []
    _, _, more = train_loop(cfg, steps_n=4, batch=2, seq=16, ckpt_dir=d,
                            device=cuda, log=logs.append)
    assert logs[0] == "resumed from step 3" and len(more) == 1


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-7b"])
def test_ssm_families_on_card_match_cpu(cuda, name):
    """Reduced mamba2-370m and zamba2-7b (two groups: the shared block
    used twice) at float32, the card against the CPU: the forward's
    hidden states within 1e-5, three decode steps' logits and every
    cache leaf (dtype included: the conv states turn float32 after the
    first step), and a train step's loss within 1e-5, each gradient leaf
    within 1e-5 of its own max |g| (plus 4 ulp)."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                          generator=g) for k in ("tokens", "labels")}
    bc = {k: v.to(cuda) for k, v in b.items()}
    with torch.no_grad():
        h = lm.forward(cfg, pc, bc)
        h0 = lm.forward(cfg, p, b)
    torch.testing.assert_close(h.cpu(), h0, rtol=1e-5, atol=1e-5)
    caches = [steps.init_cache(cfg, 2, 8, device=d) for d in (cuda, "cpu")]
    dec = steps.make_decode_step(cfg)
    for t in range(3):
        lg, caches[0] = dec(pc, caches[0], bc["tokens"][:, t:t + 1])
        lg0, caches[1] = dec(p, caches[1], b["tokens"][:, t:t + 1])
        torch.testing.assert_close(lg.cpu(), lg0, rtol=1e-5, atol=1e-5)
    assert caches[0]["pos"] == caches[1]["pos"] == 3
    assert caches[0]["conv_x"].dtype == torch.float32
    for k in sorted(set(caches[1]) - {"pos"}):
        a, w = caches[0][k], caches[1][k]
        assert a.device.type == "cuda" and a.dtype == w.dtype, k
        tol = 1e-2 if k in ("k", "v") else 1e-5          # K/V in bfloat16
        torch.testing.assert_close(a.cpu(), w, rtol=tol, atol=tol)
    lc, gc = steps.value_and_grad(cfg, pc, bc)
    l0, g0 = steps.value_and_grad(cfg, p, b)
    assert abs(float(lc) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, w in zip(T.leaves(gc), T.leaves(g0)):
        scale = float(w.abs().max())
        assert scale > 1e-8
        assert float((a.cpu() - w).abs().max()) <= 1e-5 * scale + 4 * float(
            np.spacing(np.float32(scale)))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_families_serve_on_the_card_by_default(cuda, arch):
    """``python -m repro_torch.launch.serve --arch <ssm or hybrid>`` with
    no ``--device`` serves on the card (reduced here)."""
    from repro_torch.launch import serve as lserve
    toks, st = lserve.main(["--arch", arch, "--reduced", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4"])
    assert toks.device.type == "cuda" and toks.shape == (2, 5)
    assert st["peak_mb"] > 0


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_frontend_families_on_card_match_cpu(cuda, name):
    """Reduced seamless-m4t-large-v2 (encdec: 24 frames) and
    llava-next-mistral-7b (vlm: an 8-patch prefix) at float32, the card
    against the CPU: the forward's hidden states and prefill's logits
    within 1e-5, vlm's prefill K/V, three decode steps' logits — encdec
    on seeded random cross caches — and every cache leaf, and `serve`'s
    greedy tokens equal."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    g = torch.Generator().manual_seed(0)
    P = 24 if cfg.family == "encdec" else 8
    b = {"tokens": torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int32,
                                 generator=g),
         "frontend_embeds": 0.02 * torch.randn((2, P, cfg.d_model),
                                               generator=g)}
    bc = {k: v.to(cuda) for k, v in b.items()}
    with torch.no_grad():
        torch.testing.assert_close(lm.forward(cfg, pc, bc).cpu(),
                                   lm.forward(cfg, p, b), rtol=1e-5,
                                   atol=1e-5)
    (lg, c), (lg0, c0) = (steps.make_prefill(cfg)(q, x)
                          for q, x in ((pc, bc), (p, b)))
    torch.testing.assert_close(lg.cpu(), lg0, rtol=1e-5, atol=1e-5)
    assert sorted(c) == sorted(c0) and c["pos"] == c0["pos"]
    for k in set(c) - {"pos"}:                    # bfloat16 K/V
        torch.testing.assert_close(c[k].cpu(), c0[k], rtol=1e-2, atol=1e-2)
    caches = [steps.init_cache(cfg, 2, 8, device=d) for d in (cuda, "cpu")]
    if cfg.family == "encdec":
        for n in ("cross_k", "cross_v"):
            r = torch.randn(tuple(caches[1][n].shape),
                            generator=g).to(torch.bfloat16)
            caches[0][n], caches[1][n] = r.to(cuda), r
    dec = steps.make_decode_step(cfg)
    for t in range(3):
        lg, caches[0] = dec(pc, caches[0], bc["tokens"][:, t:t + 1])
        lg0, caches[1] = dec(p, caches[1], b["tokens"][:, t:t + 1])
        torch.testing.assert_close(lg.cpu(), lg0, rtol=1e-5, atol=1e-5)
    assert caches[0]["pos"] == caches[1]["pos"] == 3
    for k in sorted(set(caches[1]) - {"pos"}):
        a, w = caches[0][k], caches[1][k]
        assert a.device.type == "cuda" and a.dtype == w.dtype, k
        torch.testing.assert_close(a.cpu(), w, rtol=1e-2, atol=1e-2)
    got, st = serve(cfg, batch=2, prompt_len=16, gen=8, device=cuda,
                    params=pc, log=lambda *_: None)
    ref, _ = serve(cfg, batch=2, prompt_len=16, gen=8, device="cpu",
                   params=p, log=lambda *_: None)
    assert torch.equal(got.cpu(), ref) and st["peak_mb"] > 0


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_frontend_families_serve_on_the_card_by_default(cuda, arch):
    """``python -m repro_torch.launch.serve --arch <encdec or vlm>`` with
    no ``--device`` serves on the card (reduced here)."""
    from repro_torch.launch import serve as lserve
    toks, st = lserve.main(["--arch", arch, "--reduced", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4"])
    assert toks.device.type == "cuda" and toks.shape == (2, 5)
    assert st["peak_mb"] > 0


def _moe_routed(cfg, params, tk):
    """The moe forward composed layer by layer → (logits on the CPU, each
    layer's expert ids on the CPU)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm, steps
    from repro_torch.models import moe as MOE
    x, eids = lm.embed_tokens(params, cfg, tk), []
    for i in range(cfg.L):
        pl = lm.layer(params["layers"], i)
        x, _ = lm._attn_sublayer(pl, x, cfg, causal=True)
        eids.append(MOE.router(pl, L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                               cfg)[0].cpu())
        x = lm._ffn_sublayer(pl, x, cfg)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return steps.logits_of(cfg, params, h).cpu(), eids


@pytest.mark.parametrize("name", ["dbrx-132b", "arctic-480b"])
def test_moe_family_on_card_matches_cpu(cuda, name):
    """Reduced dbrx-132b (every token to all 4 experts) and arctic-480b
    (top 2 of 4, the dense residual MLP) at float32, the card against
    the CPU: each layer's routes equal, the logits within 1e-4, and
    `serve`'s greedy tokens equal."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    toks = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))

    with torch.no_grad():
        lg, e = _moe_routed(cfg, pc, toks.to(cuda))
        lg0, e0 = _moe_routed(cfg, p, toks)
        want = steps.logits_of(cfg, pc, lm.forward(cfg, pc, {
            "tokens": toks.to(cuda)})).cpu()
    assert torch.equal(lg, want)                 # the composed loop = forward
    for a, w in zip(e, e0):
        assert torch.equal(a, w)
    torch.testing.assert_close(lg, lg0, rtol=1e-4, atol=1e-4)
    got, st = serve(cfg, batch=2, prompt_len=16, gen=8, device=cuda,
                    params=pc, log=lambda *_: None)
    ref, _ = serve(cfg, batch=2, prompt_len=16, gen=8, device="cpu",
                   params=p, log=lambda *_: None)
    assert torch.equal(got.cpu(), ref) and st["peak_mb"] > 0


def test_moe_family_serves_on_the_card_by_default(cuda):
    """``python -m repro_torch.launch.serve --arch dbrx-132b --reduced``
    with no ``--device`` serves on the card."""
    from repro_torch.launch import serve as lserve
    toks, st = lserve.main(["--arch", "dbrx-132b", "--reduced", "--batch",
                            "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.device.type == "cuda" and toks.shape == (2, 5)
    assert st["peak_mb"] > 0


def _moe_cfg(name, **kw):
    """A reduced moe config; "dbrx-132b:16x4" keeps dbrx's 16 experts and
    top 4 (the reduced config's 4 experts take every token)."""
    from repro_torch.configs import base as CB
    name, _, experts = name.partition(":")
    if experts:
        E, k = map(int, experts.split("x"))
        kw = dict(kw, n_experts=E, moe_top_k=k)
    return dataclasses.replace(CB.reduced(CB.get(name)), **kw)


@pytest.mark.parametrize("name", ["dbrx-132b", "arctic-480b",
                                  "dbrx-132b:16x4"])
def test_moe_train_step_on_card_matches_cpu(cuda, name):
    """The moe family's training at float32, the card against the CPU,
    routes first: each layer's routes equal; the loss within 1e-5 and
    each gradient leaf (the router and the expert stacks too) within
    1e-5 of its own max |g| (plus 4 ulp); one Adam update of the same
    gradients within 1e-6; a µ = 2 train step's loss within 1e-5 and its
    first moment within 1e-5 of each leaf's max."""
    from repro_torch import tree as T
    from repro_torch.models import lm, steps
    cfg = _moe_cfg(name, dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32,
                          generator=g) for k in ("tokens", "labels")}
    bc = {k: v.to(cuda) for k, v in b.items()}
    with torch.no_grad():
        _, e = _moe_routed(cfg, pc, bc["tokens"])
        _, e0 = _moe_routed(cfg, p, b["tokens"])
    for a, w in zip(e, e0):
        assert torch.equal(a, w)

    def close(got, want, rel=1e-5):
        for a, w in zip(T.leaves(got), T.leaves(want)):
            scale = float(w.float().abs().max())
            assert scale > 1e-9
            assert float((a.cpu().float() - w.float()).abs().max()) <= (
                rel * scale + 4 * float(np.spacing(np.float32(scale))))

    lc, gc = steps.value_and_grad(cfg, pc, bc)
    l0, g0 = steps.value_and_grad(cfg, p, b)
    assert abs(float(lc) - float(l0)) <= 1e-5 * abs(float(l0))
    close(gc, g0)
    grads = T.tree_map(lambda t: t.cpu(), gc)
    on_cpu = steps.adam_update(cfg, T.tree_map(torch.clone, p), grads,
                               steps.init_opt(cfg, p))
    on_card = steps.adam_update(cfg, T.tree_map(torch.clone, pc),
                                T.tree_map(lambda t: t.to(cuda), grads),
                                steps.init_opt(cfg, pc))
    for a, w in zip(T.leaves(on_card[:2]), T.leaves(on_cpu[:2])):
        assert float((a.cpu().double() - w.double()).abs().max()) <= 1e-6
    mcfg = dataclasses.replace(cfg, microbatches=2)
    step = steps.make_train_step(mcfg)
    _, oc, auxc = step(T.tree_map(torch.clone, pc), steps.init_opt(mcfg, pc),
                       bc)
    _, o0, aux0 = step(T.tree_map(torch.clone, p), steps.init_opt(mcfg, p), b)
    assert abs(float(auxc["loss"]) - float(aux0["loss"])) <= 1e-5 * abs(
        float(aux0["loss"]))
    close(oc["m"], o0["m"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_backward_on_card_is_bit_reproducible(cuda, dtype):
    """"dbrx-132b:16x4" on the card: two backward passes give bit-equal
    gradients (no atomic add: the pairs move by permutations, each
    expert's weight gradient is one product), and so do remat on and off
    (the recomputed layer routes as its forward did); a µ = 2 train step
    run twice from clones of one state gives bit-equal parameters and
    moments."""
    from repro_torch import tree as T
    from repro_torch.models import lm, steps
    cfg = _moe_cfg("dbrx-132b:16x4", dtype=dtype)
    p = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1, device=cuda)
    g = torch.Generator().manual_seed(1)
    b = {k: torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32,
                          generator=g).to(cuda)
         for k in ("tokens", "labels")}
    runs = [steps.value_and_grad(c, p, b) for c in (
        cfg, cfg, dataclasses.replace(cfg, remat=False))]
    for l_, gr in runs[1:]:
        assert torch.equal(runs[0][0], l_)
        for a, w in zip(T.leaves(runs[0][1]), T.leaves(gr)):
            assert torch.equal(a, w)
    mcfg = dataclasses.replace(cfg, microbatches=2, moment_dtype="bfloat16")
    state = (p, steps.init_opt(mcfg, p))
    outs = []
    for _ in range(2):
        pr, orun = T.tree_map(torch.clone, state)
        for _ in range(2):
            pr, orun, _ = steps.make_train_step(mcfg)(pr, orun, b)
        outs.append(T.leaves((pr, orun)))
    for a, w in zip(*outs):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_moe_bfloat16_moment_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Reduced dbrx-132b with its own bfloat16 moments and µ = 2 on the
    card: the step-2 checkpoint restores onto the card bit for bit, the
    moments as bfloat16, and the resumed loop's losses equal a loop
    continued from the same state in memory."""
    from repro_torch import tree as T
    from repro_torch.launch.train import synth_batch, train_loop
    from repro_torch.models import steps
    from repro_torch.train import checkpoint as ckpt
    cfg = _moe_cfg("dbrx-132b", moment_dtype="bfloat16", microbatches=2)
    d = str(tmp_path)
    p, opt, _ = train_loop(cfg, steps_n=2, batch=4, seq=16, ckpt_dir=d,
                           ckpt_every=2, device=cuda, log=lambda *_: None)
    got, step = ckpt.restore(d, (p, opt))
    assert step == 2 and T.leaves(got[1]["m"])[0].dtype == torch.bfloat16
    for a, w in zip(T.leaves(got), T.leaves((p, opt))):
        assert a.device.type == "cuda" and a.dtype == w.dtype
        assert torch.equal(a, w)
    step_fn = steps.make_train_step(cfg)
    rng, want = np.random.default_rng(0), []
    for _ in range(2):
        p, opt, aux = step_fn(p, opt, synth_batch(rng, cfg, 4, 16,
                                                  device=cuda))
        want.append(float(aux["loss"]))
    logs = []
    _, _, more = train_loop(cfg, steps_n=4, batch=4, seq=16, ckpt_dir=d,
                            device=cuda, log=logs.append)
    assert logs[0] == "resumed from step 2" and more == want


def test_moe_training_runs_on_the_card_by_default(cuda):
    """``python -m repro_torch.launch.train --arch dbrx-132b --reduced``
    with no ``--device`` trains on the card, and so does `train_loop`."""
    from repro_torch import tree as T
    from repro_torch.launch import train as ltrain
    losses = ltrain.main(["--arch", "dbrx-132b", "--reduced", "--steps",
                          "2", "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    p, opt, _ = ltrain.train_loop(_moe_cfg("arctic-480b"), steps_n=1,
                                  batch=2, seq=16, log=lambda *_: None)
    assert all(t.device.type == "cuda" for t in T.leaves((p, opt)))


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_frontend_train_step_on_card_matches_cpu(cuda, name):
    """Reduced seamless-m4t-large-v2 (encdec: 16 frames) and
    llava-next-mistral-7b (vlm: 16 patches) at float32, the card against
    the CPU: the loss within 1e-5 and each gradient leaf within 1e-5 of
    its own max |g| (plus 4 ulp); remat on = off bit for bit on the card;
    one Adam update of the same gradients within 1e-6; a µ = 2 train
    step (``frontend_embeds`` split with the tokens) — the loss within
    1e-5 and its first moment within 1e-5 of each leaf's max."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.models import lm, steps
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    g = torch.Generator().manual_seed(0)
    b = {k: torch.randint(0, cfg.vocab, (4, 16), dtype=torch.int32,
                          generator=g) for k in ("tokens", "labels")}
    b["frontend_embeds"] = 0.02 * torch.randn((4, 16, cfg.d_model),
                                              generator=g)
    bc = {k: v.to(cuda) for k, v in b.items()}

    def close(got, want, rel=1e-5):
        for a, w in zip(T.leaves(got), T.leaves(want)):
            scale = float(w.float().abs().max())
            assert scale > 1e-9
            assert float((a.cpu().float() - w.float()).abs().max()) <= (
                rel * scale + 4 * float(np.spacing(np.float32(scale))))

    lc, gc = steps.value_and_grad(cfg, pc, bc)
    l0, g0 = steps.value_and_grad(cfg, p, b)
    assert abs(float(lc) - float(l0)) <= 1e-5 * abs(float(l0))
    close(gc, g0)
    l_off, g_off = steps.value_and_grad(dataclasses.replace(cfg, remat=False),
                                        pc, bc)
    assert torch.equal(l_off, lc)
    for a, w in zip(T.leaves(g_off), T.leaves(gc)):
        assert torch.equal(a, w)
    grads = T.tree_map(lambda t: t.cpu(), gc)
    on_cpu = steps.adam_update(cfg, T.tree_map(torch.clone, p), grads,
                               steps.init_opt(cfg, p))
    on_card = steps.adam_update(cfg, T.tree_map(torch.clone, pc),
                                T.tree_map(lambda t: t.to(cuda), grads),
                                steps.init_opt(cfg, pc))
    for a, w in zip(T.leaves(on_card[:2]), T.leaves(on_cpu[:2])):
        assert float((a.cpu().double() - w.double()).abs().max()) <= 1e-6
    mcfg = dataclasses.replace(cfg, microbatches=2)
    step = steps.make_train_step(mcfg)
    _, oc, auxc = step(T.tree_map(torch.clone, pc), steps.init_opt(mcfg, pc),
                       bc)
    _, o0, aux0 = step(T.tree_map(torch.clone, p), steps.init_opt(mcfg, p), b)
    assert abs(float(auxc["loss"]) - float(aux0["loss"])) <= 1e-5 * abs(
        float(aux0["loss"]))
    close(oc["m"], o0["m"])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_frontend_families_train_on_the_card_by_default(cuda, arch):
    """``python -m repro_torch.launch.train --arch <encdec or vlm>
    --reduced`` with no ``--device`` trains on the card, and so does
    `train_loop`, whose batches carry the stub frontend draws there."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch import train as ltrain
    losses = ltrain.main(["--arch", arch, "--reduced", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = CB.reduced(CB.get(arch))
    p, opt, _ = ltrain.train_loop(cfg, steps_n=1, batch=2, seq=16,
                                  log=lambda *_: None)
    assert all(t.device.type == "cuda" for t in T.leaves((p, opt)))
    b = ltrain.synth_batch(np.random.default_rng(0), cfg, 2, 16,
                           device=p["embed"].device)
    assert b["frontend_embeds"].device.type == "cuda"


def test_bfloat16_draw_on_card_equals_cpu(cuda):
    """The bfloat16 normal draw on the card, bit for bit the CPU's: the
    128-value table, a leaf in chunks of 2²⁰ and in one, a draw into a
    slice of a stack, and reduced llama3-405b's and arctic-480b's whole
    bfloat16 `init_params` trees."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.models import lm
    bits = lambda t: t.cpu().view(torch.int16)
    assert torch.equal(bits(prng._bf16_table(cuda, normal=True)),
                       bits(prng._bf16_table("cpu", normal=True)))
    key = prng.split(prng.PRNGKey(4))[1]
    shape = (3, 1000, 777)
    want = prng.normal_chunked(key, shape, dtype=torch.bfloat16)
    for chunk in (1 << 20, 1 << 24):
        got = prng.normal_chunked(key, shape, device=cuda, chunk=chunk,
                                  dtype=torch.bfloat16)
        assert got.device.type == "cuda" and torch.equal(bits(got),
                                                         bits(want))
    stack = torch.zeros((2, *shape), dtype=torch.bfloat16, device=cuda)
    prng.normal_chunked(key, shape, device=cuda, dtype=torch.bfloat16,
                        out=stack[1])
    assert torch.equal(bits(stack[1]), bits(want))
    assert not bool(stack[0].any())
    for name in ("llama3-405b", "arctic-480b"):
        cfg = dataclasses.replace(CB.reduced(CB.get(name)),
                                  param_dtype="bfloat16")
        pc = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1,
                            device=cuda)
        p = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1,
                           device="cpu")
        for a, w in zip(T.leaves(pc), T.leaves(p)):
            assert a.dtype == torch.bfloat16 and torch.equal(bits(a), bits(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_on_card_equals_cpu_beside_the_meta_tree(cuda, dtype):
    """Reduced llama3-405b and arctic-480b drawn on the card equal the
    CPU's draw, bit for bit in bfloat16 and within 4 ulp in float32 (the
    port's draw bound against the JAX package's), with a meta tree built
    before and after the draws; each meta tree has the drawn tree's
    paths, shapes and dtypes and holds no storage."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.models import lm
    for name in ("llama3-405b", "arctic-480b"):
        cfg = dataclasses.replace(CB.reduced(CB.get(name)),
                                  param_dtype=dtype)
        meta = lambda: lm.init_params(cfg, prng.PRNGKey(1), model_shards=1,
                                      device="meta")
        before = meta()
        pc = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1,
                            device=cuda)
        p = lm.init_params(cfg, prng.PRNGKey(1), model_shards=1,
                           device="cpu")
        after = meta()
        for (path, a), (_, w), (_, m0), (_, m1) in zip(
                T.leaves_with_paths(pc), T.leaves_with_paths(p),
                T.leaves_with_paths(before), T.leaves_with_paths(after)):
            assert a.device.type == "cuda" and a.dtype == w.dtype, path
            if dtype == "bfloat16":
                assert torch.equal(a.cpu().view(torch.int16),
                                   w.view(torch.int16)), path
            else:
                np.testing.assert_array_max_ulp(a.cpu().numpy(), w.numpy(),
                                                maxulp=4)
            for m in (m0, m1):
                assert m.is_meta and m.shape == w.shape \
                    and m.dtype == w.dtype, path
        assert len(T.leaves(before)) == len(T.leaves(pc))


def test_logits_of_a_bfloat16_table_makes_no_float32_copy_on_card(
        cuda, monkeypatch):
    """`steps.logits_of` on a bfloat16 [V, D] output table raises
    `max_memory_allocated` by less than V·D·4 bytes (a float32 copy of
    the table), and its logits are within float32 rounding of the
    unchunked float32 product, TF32 off."""
    from repro_torch.configs import base as CB
    from repro_torch.models import steps
    cfg = dataclasses.replace(CB.get("llama3-405b"), L=1)
    V, D = 65536, 4096
    g = torch.Generator(device=cuda).manual_seed(0)
    E = torch.randn((V, D), generator=g, device=cuda).to(torch.bfloat16)
    h = torch.randn((4, 1, D), generator=g, device=cuda).to(torch.bfloat16)
    p = {"embed": E, "out_embed": E}
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    monkeypatch.setattr(steps, "LOGITS_CHUNK", 1 << 24)
    got = steps.logits_of(cfg, p, h)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise < V * D * 4, rise
    want = h.float().cpu() @ E.float().cpu().T
    bound = 2 * D * 2.0 ** -24 * (h.float().abs().cpu()
                                  @ E.float().abs().cpu().T)
    assert got.dtype == torch.float32
    assert bool(((got.cpu() - want).abs() <= bound).all())


@pytest.mark.parametrize("name", ["llama3-405b", "arctic-480b"])
def test_bfloat16_parameters_serve_on_card_as_on_cpu(cuda, name):
    """Reduced llama3-405b and arctic-480b with bfloat16 parameters, drawn
    by `serve` itself on each device at float32 compute: the greedy
    tokens equal."""
    from repro_torch.configs import base as CB
    from repro_torch.launch.serve import serve
    cfg = dataclasses.replace(CB.reduced(CB.get(name)),
                              param_dtype="bfloat16", dtype="float32")
    got, st = serve(cfg, batch=2, prompt_len=16, gen=8, device=cuda,
                    log=lambda *_: None)
    ref, _ = serve(cfg, batch=2, prompt_len=16, gen=8, device="cpu",
                   log=lambda *_: None)
    assert torch.equal(got.cpu(), ref) and st["peak_mb"] > 0


def _bf16_train_cfg(name, **kw):
    """Reduced ``name`` with bfloat16 parameters, gradient sum and moments
    at µ = 2."""
    from repro_torch.configs import base as CB
    return dataclasses.replace(
        CB.reduced(CB.get(name)), param_dtype="bfloat16",
        moment_dtype="bfloat16", grad_dtype="bfloat16", microbatches=2,
        **kw)


@pytest.mark.parametrize("name", ["llama3-405b", "arctic-480b"])
def test_bfloat16_train_step_on_card_equals_cpu(cuda, name, monkeypatch):
    """Reduced llama3-405b and arctic-480b in bfloat16 parameters,
    gradient sum and moments, a µ = 2 step at float32 compute (TF32 off)
    on the card and on the CPU from the same state: arctic's routes of
    each microbatch equal first; the loss within 1e-5; each leaf of the
    gradient sum handed to Adam within 8u of its max (u = 2⁻⁸: each
    microbatch's float32 gradient rounds to bfloat16 at most one ulp, 2u,
    apart, and their sum once more), a dropped microbatch above it; the
    CPU's Adam of the card's sum against the card's: every parameter and
    moment word within one bfloat16 ulp."""
    from chip_smoke import captured_step, moe_routes, worst_leaf
    from repro_torch import tree as T
    from repro_torch.models import lm, steps
    # `captured_step` wraps it: the plain update again after the test
    monkeypatch.setattr(steps, "adam_update", steps.adam_update)
    u = 2.0 ** -8
    cfg = _bf16_train_cfg(name, dtype="float32")
    p = lm.init_params(cfg, prng.PRNGKey(3), model_shards=1, device="cpu")
    rng = np.random.default_rng(3)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    assert not torch.backends.cuda.matmul.allow_tf32
    if cfg.family == "moe":
        with torch.no_grad():
            for i in range(2):
                toks = b["tokens"][2 * i:2 * i + 2]
                assert torch.equal(moe_routes(cfg, p, toks)[1], moe_routes(
                    cfg, T.tree_map(lambda t: t.to(cuda), p),
                    toks.to(cuda))[1])
    runs = {}
    for dev, mask in (("cpu", [1.0, 1.0]), (cuda, [1.0, 1.0]),
                      (cuda, [1.0, 0.0])):
        pd = T.tree_map(lambda t: t.to(dev, copy=True), p)
        od = steps.init_opt(cfg, pd)
        batch = {k: v.to(dev) for k, v in b.items()}
        g, denom, aux = captured_step(cfg, pd, od, dict(
            batch, mb_mask=torch.tensor(mask, device=dev)),
            update=mask == [1.0, 1.0])
        runs[(str(dev), mask[1])] = (g, denom, float(aux["loss"]), pd, od)
    g0, d0, l0, _, _ = runs[("cpu", 1.0)]
    g1, d1, l1, p1, o1 = runs[("cuda", 1.0)]
    gc, dc, _, _, _ = runs[("cuda", 0.0)]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert d0 == d1 == 2.0 and dc == 1.0
    assert worst_leaf(g1, g0, (d1, d0))[0] <= 8 * u
    assert worst_leaf(gc, g0, (dc, d0))[0] > 8 * u
    pc, oc, _ = steps.adam_update(
        cfg, T.tree_map(torch.clone, p), T.tree_map(lambda t: t.cpu(), g1),
        steps.init_opt(cfg, p), denom=torch.tensor(d1))
    words = lambda t: t.cpu().reshape(-1).view(torch.int16).to(torch.int32)
    for a, w in zip(T.leaves((pc, oc["m"], oc["v"])),
                    T.leaves((p1, o1["m"], o1["v"]))):
        assert a.dtype == w.dtype == torch.bfloat16
        assert int((words(a) - words(w)).abs().max()) <= 1


def test_bfloat16_step_memory_on_card(cuda, monkeypatch):
    """A µ = 2 bfloat16 step of reduced llama3-405b at L = 1 with a
    262,144 × 256 bfloat16 output table (134 MB, 16 blocks of
    `LOGITS_CHUNK` = 2²²), after a warm step: `max_memory_allocated`
    rises above the parameters and moments by less than the gradient
    sum plus its largest leaf's gradient (the table's, made once by
    `steps._BlockedLogits`), two blocks' float32 temporaries and four
    microbatches' float32 logits — 172 MB above the sum read on the CPU's
    allocations.  The control, autograd's backward of the blocks'
    slices, makes a table-sized zero tensor a block and reads above it
    (650 MB on the CPU)."""
    from repro_torch import tree as T
    from repro_torch.models import lm, steps

    class Sliced:               # the blocks as autograd's slices
        @staticmethod
        def apply(h32, E, dt, rows):
            out = h32.new_empty((*h32.shape[:-1], E.shape[0]))
            for r in range(0, E.shape[0], rows):
                out[..., r:r + rows] = h32 @ E[r:r + rows].to(dt).float().T
            return out

    monkeypatch.setattr(steps, "LOGITS_CHUNK", 1 << 22)
    monkeypatch.setattr(steps, "ADAM_SLICE", 1 << 22)
    cfg = _bf16_train_cfg("llama3-405b", L=1, vocab=262144, d_model=256)
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device=cuda)
    opt = steps.init_opt(cfg, p)
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)).to(cuda) for k in ("tokens", "labels")}
    leaves = T.leaves(p)
    tree = sum(t.numel() * 2 for t in leaves)
    biggest = max(t.numel() * 2 for t in leaves)
    assert p["out_embed"].numel() > steps.LOGITS_CHUNK
    limit = (tree + biggest + 2 * steps.LOGITS_CHUNK * 4
             + 4 * (2 // cfg.microbatches) * 8 * cfg.vocab * 4)
    step = steps.make_train_step(cfg)
    step(p, opt, b)                                       # warm

    def rise():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(p, opt, b)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    got = rise()
    assert got < limit, (got, limit)
    monkeypatch.setattr(steps, "_BlockedLogits", Sliced)
    ctrl = rise()
    assert ctrl > limit, (ctrl, limit)


def _mesh_cut(name="arctic-480b", **kw):
    """Reduced arctic-480b with 16 experts (top 2) at capacity 0.75, where
    the dispatch drops slots, at float32."""
    from repro_torch.configs import base as CB
    return dataclasses.replace(CB.reduced(CB.get(name)), n_experts=16,
                               moe_capacity=0.75, dtype="float32", **kw)


@pytest.mark.parametrize("ep2d", [False, True])
def test_lm_mesh_on_card_matches_cpu(cuda, monkeypatch, ep2d):
    """A one-layer cut on the logical 2 × 4 mesh of the card and of the
    CPU: prefill routes equal, then the kept-slot masks, then the logits
    within 1e-4 of their max; the same for a decode step behind the
    card's prefill caches (the replicated dispatch); a train step's loss
    within 1e-5 and first moments within 1e-4 of each leaf's max.  Slots
    are dropped."""
    from chip_smoke import mesh_decode, mesh_prefill, mesh_train
    from repro_torch import tree as T
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    monkeypatch.setenv(M.LOGICAL_DEVICES, "8")
    cfg = _mesh_cut(L=1, moe_ep2d=ep2d)
    mc = M.compat_mesh((2, 4), ("data", "model"), device=cuda)
    mh = M.compat_mesh((2, 4), ("data", "model"), device="cpu")
    assert {d.type for d in mc.cell_devices} == {"cuda"}
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    pc = T.tree_map(lambda t: t.to(cuda), p)
    toks = torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    lg, e, mk = mesh_prefill(cfg, pc, toks.to(cuda), mc)
    lg0, e0, mk0 = mesh_prefill(cfg, p, toks, mh)
    assert torch.equal(e, e0)
    assert torch.equal(mk, mk0) and not bool(mk.all())
    scale = float(lg0.abs().max())
    assert float((lg - lg0).abs().max()) <= 1e-4 * scale
    lg, e, mk, kv = mesh_decode(cfg, pc, toks.to(cuda),
                                toks[:, :1].to(cuda), mc)
    lg0, e0, mk0, _ = mesh_decode(cfg, p, toks, toks[:, :1], mh, kv)
    assert torch.equal(e, e0) and torch.equal(mk, mk0)
    assert float((lg - lg0).abs().max()) <= 1e-4 * float(lg0.abs().max())
    loss, gn, m = mesh_train(cfg, pc, toks.to(cuda), mc)
    loss0, gn0, m0 = mesh_train(cfg, p, toks, mh)
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    for a, w in zip(T.leaves(m), T.leaves(m0)):
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


@pytest.mark.parametrize("path", ["a2a", "rep", "ep2d"])
def test_moe_dispatch_on_card_is_bit_reproducible(cuda, monkeypatch, path):
    """`moe_ffn` (a2a and rep) and `moe_ffn_ep2d` on the card's logical
    2 × 4 mesh, forward and backward twice: bit-equal outputs and
    gradients, the combine through `segment_add` (launched once a cell)."""
    from repro_torch.core import scatter
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe
    from repro_torch.models import sharding as SH
    monkeypatch.setenv(M.LOGICAL_DEVICES, "8")
    cfg = _mesh_cut(moe_top_k=4)
    mesh = M.compat_mesh((2, 4), ("data", "model"), device=cuda)
    axes = SH.mesh_axes(mesh)
    g = torch.Generator().manual_seed(0)
    D, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    w = {n: (0.05 * torch.randn(*s, generator=g)).to(cuda)
         for n, s in (("router", (D, E)), ("w1", (E, D, ff)),
                      ("w3", (E, D, ff)), ("w2", (E, ff, D)))}
    x0 = torch.randn(4, 16, D, generator=g).to(cuda)
    cot = torch.randn(4, 16, D, generator=g).to(cuda)
    eid, gate0 = moe.router(w, x0, cfg)

    def run():
        x = x0.clone().requires_grad_(True)
        gate = gate0.clone().requires_grad_(True)
        ws = {n: w[n].clone().requires_grad_(True) for n in ("w1", "w3",
                                                             "w2")}
        before = scatter.LAUNCHES
        if path == "ep2d":
            y = moe.moe_ffn_ep2d(ws, x, eid, gate, cfg, mesh, axes)
        else:
            y = moe.moe_ffn(ws, x, eid, gate, cfg, mesh, axes,
                            shard_seq=path == "a2a")
        assert scatter.LAUNCHES - before == mesh.size
        (y * cot).sum().backward()
        return [y.detach(), x.grad, gate.grad,
                *(ws[n].grad for n in ("w1", "w3", "w2"))]

    a, b = run(), run()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_perf_mem_peak_on_card_is_at_least_the_arguments(cuda, tmp_path):
    """`perf.run(..., do_mem=True)` draws the cut on the card and runs one
    step: its measured peak is at least the cut's meta argument bytes
    (the arguments are resident through the step), and names the card."""
    from repro_torch.configs import base as CB
    from repro_torch.launch import perf
    rec = perf.run("qwen3-0.6b", "decode_32k", [("L", 1)], "cuda", True,
                   outdir=str(tmp_path))
    assert rec["peak_bytes"] >= rec["argument_bytes"] > 0
    assert rec["peak_source"].startswith("measured on ")
    assert rec["argument_bytes"] == perf._meta_argument_bytes(
        dataclasses.replace(CB.get("qwen3-0.6b"), L=1),
        CB.SHAPES["decode_32k"])
    cfg = dataclasses.replace(CB.reduced(CB.get("arctic-480b")), L=1)
    got = perf.measure_peak(cfg, CB.ShapeSpec("train_s", 32, 4, "train"))
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
