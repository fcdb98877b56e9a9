"""Port vs JAX package: the two serving kernels and their ops wrappers.

The port's plain versions must equal the JAX package's `ref` functions
and its Pallas kernels run in interpret mode (the `lsh_retrieve` one in
`test_torch_lsh_retrieve_interpret*.py`), on the parameter sweeps of
`tests/test_lsh_retrieve.py` and `tests/test_serve.py`: `lsh_retrieve`
bit for bit, `candidate_score` within rtol/atol 1e-5 (the JAX package's
own tolerance) with equal indices wherever neighbouring top-N scores
differ by more than 1e-5.  On the CPU the kernel wrappers run the plain
versions and launch nothing; `test_torch_cuda.py` holds the CUDA kernels
against the plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simlsh as jsim
from repro.data.sparse import from_coo as jfrom_coo
from repro.kernels.candidate_score.kernel import \
    candidate_score_topn as jscore_kernel
from repro.kernels.candidate_score.ops import score_candidates as jscore_ops
from repro.kernels.candidate_score.ref import \
    candidate_score_topn_ref as jscore_ref
from repro.kernels.lsh_retrieve.ops import \
    retrieve_candidates as jretrieve_ops
from repro.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref as jlsh_ref
from repro.serve import build_index as jbuild
from repro.serve import insert as jinsert
from repro.serve import padded_flat_ids as jpadded
from repro.serve import seed_items as jseed
from repro.serve import tail_hits as jtail
from repro.serve import window_slices as jwindows
from repro_torch import convert
from repro_torch.core.model import ServePlanes
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.candidate_score.ops import score_candidates
from repro_torch.kernels.candidate_score.ref import (NEG, assert_topn_close,
                                                    candidate_score_topn_ref)
from repro_torch.kernels.lsh_retrieve.ops import retrieve_candidates
from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref
from repro_torch.serve import insert

SENTINEL = 2 ** 31 - 1


def _sparse(M=200, N=60, seed=0):
    """`tests/test_lsh_retrieve.py::_sparse`: integer ratings, many ties."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(M), 6).astype(np.int32)
    cols = rng.integers(0, N, M * 6).astype(np.int32)
    vals = rng.integers(1, 6, M * 6).astype(np.float32)
    _, uniq = np.unique(rows.astype(np.int64) * N + cols, return_index=True)
    return rows[uniq], cols[uniq], vals[uniq], (M, N)


@pytest.fixture(scope="module")
def indexed():
    """JAX state and the port's copy of it: (jsp, jidx, jidx_tail, tsp,
    tidx, tidx_tail); the tail holds five cloned items."""
    rows, cols, vals, shape = _sparse()
    jsp = jfrom_coo(rows, cols, vals, shape)
    sigs = jsim.encode(jsp, jsim.SimLSHConfig(G=8, p=2, q=8),
                       jax.random.PRNGKey(0))
    jidx = jbuild(sigs, tail_cap=32)
    src = np.asarray([0, 3, 7, 11, 19])
    new = np.arange(60, 65, dtype=np.int32)
    jidx_t = jinsert(jidx, sigs[:, src], jnp.asarray(new))
    tsp = convert.sparse_from_numpy(rows, cols, vals, shape, device="cpu")
    tidx = convert.index_from_numpy(np.asarray(sigs), tail_cap=32,
                                    device="cpu")
    tidx_t = insert(tidx, torch.tensor(np.asarray(sigs)[:, src]),
                    torch.tensor(new))
    return jsp, jidx, jidx_t, tsp, tidx, tidx_t


def _lsh_inputs(jsp, jidx, *, B, n_seeds, cap, tail):
    """The JAX package's kernel operands (`test_lsh_retrieve.py`), as
    numpy: starts, lens, extra, ids_flat."""
    users = jnp.arange(B, dtype=jnp.int32)
    seeds = jseed(jsp, users, n_seeds=n_seeds, window=32)
    starts, lens = jwindows(jidx, seeds, cap=cap)
    extra = (jtail(jidx, seeds) if tail
             else jnp.full((B, 1), SENTINEL, jnp.int32))
    return tuple(np.asarray(x) for x in
                 (starts, lens, extra, jpadded(jidx, cap=cap)))


GEOMETRIES = [(4, 8, 32), (4, 8, 16), (8, 4, 64), (2, 16, 24), (5, 8, 48)]
EXCLUDES = [(), (1, 9), (SENTINEL,)]


# --------------------------------------------------------- lsh_retrieve

@pytest.mark.parametrize("n_seeds,cap,C", GEOMETRIES)
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("excl", EXCLUDES)
def test_lsh_retrieve_ref_matches_jax_ref(indexed, n_seeds, cap, C, tail,
                                          excl):
    """Bit-exact against the JAX package's oracle, over its own sweep."""
    jsp, jidx, jidx_t, *_ = indexed
    ops = _lsh_inputs(jsp, jidx_t if tail else jidx, B=12, n_seeds=n_seeds,
                      cap=cap, tail=tail)
    exclude = np.asarray(list(excl) or [SENTINEL], np.int32)
    want = jlsh_ref(*map(jnp.asarray, ops), jnp.asarray(exclude), C=C,
                    cap=cap)
    got = lsh_retrieve_topc_ref(*map(torch.tensor, ops),
                                torch.tensor(exclude), C=C, cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_retrieve_candidates_matches_jax_ops(indexed, tail, impl):
    """`ops.retrieve_candidates` with the popularity shortlist reserved in
    trailing slots and excluded from the walked core."""
    jsp, jidx, jidx_t, tsp, tidx, tidx_t = indexed
    popular = np.asarray([2, 11, 17], np.int32)
    kw = dict(n_seeds=4, cap=8, C=48, window=32, tail_scan=tail)
    want = jretrieve_ops(jidx_t if tail else jidx, jsp,
                         jnp.arange(12, dtype=jnp.int32),
                         popular=jnp.asarray(popular), impl="ref", **kw)
    got = retrieve_candidates(tidx_t if tail else tidx, tsp,
                              torch.arange(12, dtype=torch.int32),
                              popular=torch.tensor(popular), impl=impl, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_retrieve_candidates_without_shortlist(indexed):
    jsp, jidx, _, tsp, tidx, _ = indexed
    kw = dict(n_seeds=4, cap=8, C=40, window=32, tail_scan=False)
    want = jretrieve_ops(jidx, jsp, jnp.arange(9, dtype=jnp.int32),
                         impl="ref", **kw)
    got = retrieve_candidates(tidx, tsp, torch.arange(9, dtype=torch.int32),
                              **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_impl_selection_is_explicit(indexed):
    *_, tsp, tidx, _ = indexed
    users = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        retrieve_candidates(tidx, tsp, users, n_seeds=4, cap=8, C=16,
                            impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        retrieve_candidates(tidx, tsp, users, n_seeds=4, cap=8, C=16,
                            impl="pallas")


# ------------------------------------------------------ candidate_score

def _plane_args(B, C, F, N, rng, mask_p=0.7):
    """`tests/test_serve.py::_plane_args` as numpy: urow [B, F+1], plane
    [N, F+1], cand ids [B, C] (pre-clipped), mask [B, C]."""
    urow = rng.normal(size=(B, F + 1)).astype(np.float32)
    plane = rng.normal(size=(N, F + 1)).astype(np.float32)
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    mask = (rng.random((B, C)) < mask_p).astype(np.float32)
    return urow, plane, cand, mask


def _flush_args(urow, plane, cand, mask):
    """The fused scorer's operands that reproduce a tile case: the user
    rows as the row plane (μ = 0, so μ + b is the bias column as is),
    users 0..B-1, and masked slots padded with SENTINEL."""
    users = np.arange(urow.shape[0], dtype=np.int32)
    padded = np.where(mask > 0, cand, SENTINEL).astype(np.int32)
    return (torch.tensor(urow), torch.tensor(0.0), torch.tensor(plane),
            torch.tensor(users), torch.tensor(padded))


@pytest.mark.parametrize("B,C,F,topn,tile", [
    (32, 64, 16, 10, 8), (7, 33, 8, 5, 16), (64, 128, 32, 1, 32)])
def test_candidate_score_matches_jax_ref_and_interpret(B, C, F, topn, tile):
    ops = _plane_args(B, C, F, 200, np.random.default_rng(B * 3 + C))
    s_ref, i_ref = jscore_ref(*map(jnp.asarray, ops), topn=topn, tile_b=tile)
    s_pl, i_pl = jscore_kernel(*map(jnp.asarray, ops), topn=topn,
                               tile_b=tile, interpret=True)
    s, i = candidate_score_topn_ref(*map(torch.tensor, ops), topn=topn,
                                    tile_b=tile)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert_topn_close(s.numpy(), i.numpy(), s_ref, i_ref)
    assert_topn_close(s.numpy(), i.numpy(), s_pl, i_pl)
    # the fused entry on the same case: no launch on CPU tensors, the same
    # scores, and the winning slots translated to their item ids
    before = score_kernel.LAUNCHES
    s2, items = score_kernel.score_topn(*_flush_args(*ops), topn=topn,
                                        tile_b=tile)
    assert score_kernel.LAUNCHES == before, "a CPU tensor launched a kernel"
    assert items.dtype == torch.int32
    want = np.take_along_axis(ops[2], np.asarray(i_pl), axis=1)
    want = np.where(np.asarray(s_pl) > NEG, want, SENTINEL)
    assert_topn_close(s2.numpy(), items.numpy(), s_pl, want)


def test_candidate_score_all_masked_rows():
    urow, plane, cand, _ = _plane_args(9, 16, 8, 64, np.random.default_rng(5))
    mask = np.zeros((9, 16), np.float32)
    ops = (urow, plane, cand, mask)
    s_ref, i_ref = jscore_ref(*map(jnp.asarray, ops), topn=4, tile_b=4)
    s_pl, i_pl = jscore_kernel(*map(jnp.asarray, ops), topn=4, tile_b=4,
                               interpret=True)
    s, i = candidate_score_topn_ref(*map(torch.tensor, ops), topn=4,
                                    tile_b=4)
    for sw, iw in ((s_ref, i_ref), (s_pl, i_pl)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(iw))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sw))


def test_candidate_score_exact_ties_keep_the_lower_slot():
    """Duplicated candidate ids score identically: the lower slot wins,
    as with `lax.top_k`."""
    urow, plane, _, _ = _plane_args(6, 24, 8, 5, np.random.default_rng(2))
    cand = np.tile(np.arange(5, dtype=np.int32), (6, 5))[:, :24].copy()
    mask = np.ones((6, 24), np.float32)
    ops = (urow, plane, cand, mask)
    s_ref, i_ref = jscore_ref(*map(jnp.asarray, ops), topn=10, tile_b=4)
    s, i = candidate_score_topn_ref(*map(torch.tensor, ops), topn=10,
                                    tile_b=4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_score_candidates_matches_jax_ops(impl):
    """μ folded into the bias column, ids clipped before the gather,
    SENTINEL slots masked and deficient rows mapped back to SENTINEL; an
    all-SENTINEL row and exact ties (repeated ids) against the JAX
    package's ref and Pallas (interpret) paths."""
    rng = np.random.default_rng(11)
    M, N, F, B, C = 40, 90, 12, 10, 24
    row = rng.normal(size=(M, F + 1)).astype(np.float32)
    col = rng.normal(size=(N, F + 1)).astype(np.float32)
    users = rng.integers(0, M, B).astype(np.int32)
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    cand[rng.random((B, C)) < 0.3] = SENTINEL
    cand[0, 3:] = SENTINEL                    # a deficient row
    cand[1] = SENTINEL                        # an all-SENTINEL row
    cand[2] = np.tile([7, 3, 7, 5], C // 4)   # exact ties: repeated ids
    from repro.core.model import ServePlanes as JPlanes
    jp = JPlanes(row=jnp.asarray(row), col=jnp.asarray(col),
                 mu=jnp.asarray(2.5, jnp.float32), F=F)
    tp = ServePlanes(row=torch.tensor(row), col=torch.tensor(col),
                     mu=torch.tensor(2.5), F=F)
    before = score_kernel.LAUNCHES
    s, i = score_candidates(tp, torch.tensor(users), torch.tensor(cand),
                            topn=6, tile_b=4, impl=impl)
    assert score_kernel.LAUNCHES == before
    for jimpl in ("ref", "pallas"):
        s_w, i_w = jscore_ops(jp, jnp.asarray(users), jnp.asarray(cand),
                              topn=6, tile_b=4, impl=jimpl, interpret=True)
        assert_topn_close(s.numpy(), i.numpy(), s_w, i_w)
        np.testing.assert_array_equal(i.numpy()[:3], np.asarray(i_w)[:3])
    assert (i.numpy()[0, 3:] == SENTINEL).all()
    assert (i.numpy()[1] == SENTINEL).all() and (s.numpy()[1] == NEG).all()
    best = max((3, 5, 7), key=lambda c: row[users[2], :F] @ col[c, :F]
               + col[c, F])
    np.testing.assert_array_equal(i.numpy()[2], [best] * 6)
