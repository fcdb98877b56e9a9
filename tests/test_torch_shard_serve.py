"""Port vs JAX package: the sharded serving tier, on the CPU with four
logical devices (``REPRO_TORCH_LOGICAL_DEVICES=4``, the port's
counterpart of the XLA host-device flag the JAX package's multi-device
checks set).

Every case of `tests/test_shard_serve.py` runs on the port:

* **merge_topn** — oracle, ties, padding, commutativity, associativity,
  the XOR butterfly for D ∈ {2, 4, 8} and random splits, against the
  numpy lexsort oracle (and equal to the JAX merge where it runs);
* **the sharded index** — bounds, geometry, `validate_sharded_index`
  (clean and on corruptions, with the JAX package's verdicts), the
  local-id partition, bucket round trip, inert padding, one shard equal
  to the plain index, the build guards — bit-equal to the JAX build;
* **the shard-local walk** — the signature exchange, disjoint owners,
  union parity with the single-device walk, no padding or foreign ids,
  empty probes, `translate_local_ids`, each bit-equal to the JAX function
  on the same inputs;
* **config** — `serve_shard_count` and `resolved_shard_budget` against
  the JAX package's at the same device count.

The whole flush (`RecsysService(..., ServeConfig(shards=4))`) runs on the
catalog of the JAX package's `check_sharded_serve` (`benchmarks/
bench_serve.py::make_catalog(CatalogSpec(N=4000))`), whose index and J^K
reach the port through numpy: against the JAX per-shard functions
composed shard by shard (ids equal, scores within 1e-5); with nothing
truncated, against the single-device walks (the top-N id sets equal);
at the bench settings, recall@10 within the JAX gate of the
single-device walk's.  The read-only refusals, `stats()` and
`profile_flush` close the file.
"""
import contextlib
import dataclasses
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import model as jmodel
from repro.core import simlsh as jsim
from repro.core import topk as jtopk
from repro.data.sparse import from_coo as jfrom_coo
from repro.launch import mesh as jmesh
from repro.resil import validate_sharded_index as jvalidate_sharded
from repro.serve import RecsysService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import build_index as jbuild
from repro.serve import build_sharded_index as jbuild_sharded
from repro.serve import merge_topn as jmerge
from repro.serve import shard_bounds as jshard_bounds
from repro.serve import shard_seed_sigs as jseed_sigs
from repro.serve import shard_walk_local as jwalk_local
from repro.serve import signatures_of as jsignatures_of
from repro.serve import translate_local_ids as jtranslate
from repro.serve import retrieve as jret
from repro.serve import service as jsvc
from repro_torch import convert
from repro_torch.core.model import shard_col_plane, unshard_col_plane
from repro_torch.data.sparse import from_coo
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.candidate_score.ref import NEG
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from repro_torch.launch import mesh
from repro_torch.resil import validate_index, validate_sharded_index
from repro_torch.serve import (RecsysService, ServeConfig,
                               ShardedIngestUnsupported, build_index,
                               build_sharded_index, full_topn, merge_topn,
                               seed_items, shard_bounds, shard_local_view,
                               shard_seed_sigs, shard_walk_local,
                               sig_window_descriptors, signatures_of,
                               translate_local_ids, walk_candidates)
from repro_torch.serve.index import _EMPTY_SIG

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks.bench_serve import CatalogSpec, make_catalog  # noqa: E402

SENTINEL = 2 ** 31 - 1
TOPN = 8


@contextlib.contextmanager
def logical(n: int):
    """``n`` logical devices on the caller's one device, for the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(mesh.LOGICAL_DEVICES, str(n))
        yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# merge_topn: the numpy oracle and partial generators of the JAX suite
# ---------------------------------------------------------------------------

def oracle_topn(scores, ids, topn):
    real = ids != SENTINEL
    s, i = scores[real], ids[real]
    order = np.lexsort((i, -s))[:topn]
    out_s = np.full(topn, NEG, np.float32)
    out_i = np.full(topn, SENTINEL, np.int32)
    out_s[:order.size] = s[order]
    out_i[:order.size] = i[order]
    return out_s, out_i


def random_partials(rng, *, B, D, topn, n_ids=200, tie_prob=0.0,
                    empty_prob=0.0):
    """D disjoint-id shard partials [B, topn] (each id in one shard)."""
    sa = [np.full((B, topn), NEG, np.float32) for _ in range(D)]
    ia = [np.full((B, topn), SENTINEL, np.int32) for _ in range(D)]
    for b in range(B):
        ids = rng.choice(n_ids, size=min(n_ids, D * topn), replace=False)
        scores = rng.normal(size=ids.size).astype(np.float32)
        if tie_prob:
            scores[rng.random(ids.size) < tie_prob] = np.float32(0.5)
        take = (rng.integers(0, topn + 1, D) if empty_prob
                else np.full(D, topn))
        if empty_prob:
            take[rng.random(D) < empty_prob] = 0
        pos = 0
        for d in range(D):
            k = min(int(take[d]), ids.size - pos)
            if k <= 0:
                continue
            sa[d][b], ia[d][b] = oracle_topn(scores[pos:pos + k],
                                             ids[pos:pos + k], topn)
            pos += k
    return sa, ia


def merged_oracle(sa, ia, topn):
    s, i = np.concatenate(sa, axis=1), np.concatenate(ia, axis=1)
    outs = [oracle_topn(s[b], i[b], topn) for b in range(s.shape[0])]
    return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])


def assert_topn_equal(got_s, got_i, ref_s, ref_i):
    got_s, got_i = _np(got_s), _np(got_i)
    np.testing.assert_array_equal(got_i, ref_i)
    real = ref_i != SENTINEL
    np.testing.assert_allclose(got_s[real], ref_s[real], rtol=1e-6)
    assert np.all(got_s[~real] <= NEG)


def _merge(a, b, topn=TOPN):
    return merge_topn(_t(a[0]), _t(a[1]), _t(b[0]), _t(b[1]), topn=topn)


class TestMergeTopn:
    def test_two_shards_match_oracle_and_jax(self):
        sa, ia = random_partials(np.random.default_rng(0), B=16, D=2,
                                 topn=TOPN)
        ms, mi = _merge((sa[0], ia[0]), (sa[1], ia[1]))
        assert_topn_equal(ms, mi, *merged_oracle(sa, ia, TOPN))
        js, ji = jmerge(*(jnp.asarray(x) for x in (sa[0], ia[0], sa[1],
                                                    ia[1])), topn=TOPN)
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ms.numpy(), np.asarray(js))

    def test_ties_break_by_lower_id(self):
        ms, mi = merge_topn(torch.tensor([[3.0, 1.0]]),
                            torch.tensor([[7, 9]], dtype=torch.int32),
                            torch.tensor([[3.0, 3.0]]),
                            torch.tensor([[2, 5]], dtype=torch.int32), topn=3)
        np.testing.assert_array_equal(mi.numpy(), [[2, 5, 7]])
        np.testing.assert_allclose(ms.numpy(), [[3.0, 3.0, 3.0]])

    def test_signed_zeros_tie_and_nan_sinks(self):
        """``lax.sort``'s comparator: ±0 are one key (ties by id), every
        NaN sorts below every number."""
        s = torch.tensor([[-0.0, float("nan")]])
        t = torch.tensor([[0.0, -1.0]])
        ms, mi = merge_topn(s, torch.tensor([[9, 1]], dtype=torch.int32), t,
                            torch.tensor([[4, 2]], dtype=torch.int32), topn=4)
        np.testing.assert_array_equal(mi.numpy(), [[4, 9, 2, 1]])
        js, ji = jmerge(jnp.asarray(s.numpy()), jnp.asarray([[9, 1]]),
                        jnp.asarray(t.numpy()), jnp.asarray([[4, 2]]),
                        topn=4)
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ms.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))

    def test_all_tied_scores_sort_ids(self):
        sa, ia = random_partials(np.random.default_rng(1), B=8, D=2,
                                 topn=TOPN, tie_prob=1.0)
        ms, mi = _merge((sa[0], ia[0]), (sa[1], ia[1]))
        assert_topn_equal(ms, mi, *merged_oracle(sa, ia, TOPN))

    def test_sentinel_padded_shard_is_identity(self):
        sa, ia = random_partials(np.random.default_rng(2), B=8, D=1,
                                 topn=TOPN)
        pad = (np.full((8, TOPN), NEG, np.float32),
               np.full((8, TOPN), SENTINEL, np.int32))
        ms, mi = _merge((sa[0], ia[0]), pad)
        assert_topn_equal(ms, mi, sa[0], ia[0])

    def test_fewer_than_topn_candidates_pad(self):
        sa = np.asarray([[4.0] + [NEG] * (TOPN - 1)], np.float32)
        ia = np.asarray([[3] + [SENTINEL] * (TOPN - 1)], np.int32)
        sb = np.asarray([[2.0] + [NEG] * (TOPN - 1)], np.float32)
        ib = np.asarray([[11] + [SENTINEL] * (TOPN - 1)], np.int32)
        ms, mi = _merge((sa, ia), (sb, ib))
        np.testing.assert_array_equal(mi.numpy()[0, :2], [3, 11])
        assert np.all(mi.numpy()[0, 2:] == SENTINEL)
        assert np.all(ms.numpy()[0, 2:] <= NEG)

    def test_both_shards_empty(self):
        pad = (np.full((4, TOPN), NEG, np.float32),
               np.full((4, TOPN), SENTINEL, np.int32))
        ms, mi = _merge(pad, pad)
        assert np.all(mi.numpy() == SENTINEL) and np.all(ms.numpy() <= NEG)

    def test_commutative(self):
        sa, ia = random_partials(np.random.default_rng(3), B=8, D=2,
                                 topn=TOPN, tie_prob=0.3)
        ab = _merge((sa[0], ia[0]), (sa[1], ia[1]))
        ba = _merge((sa[1], ia[1]), (sa[0], ia[0]))
        assert torch.equal(ab[1], ba[1]) and torch.equal(ab[0], ba[0])

    def test_associative(self):
        sa, ia = random_partials(np.random.default_rng(4), B=8, D=3,
                                 topn=TOPN, tie_prob=0.2)
        j = [(_t(s), _t(i)) for s, i in zip(sa, ia)]
        left = merge_topn(*merge_topn(*j[0], *j[1], topn=TOPN), *j[2],
                          topn=TOPN)
        right = merge_topn(*j[0], *merge_topn(*j[1], *j[2], topn=TOPN),
                           topn=TOPN)
        assert torch.equal(left[1], right[1])
        assert torch.equal(left[0], right[0])

    @pytest.mark.parametrize("D", [2, 4, 8])
    def test_butterfly_fold_matches_oracle(self, D):
        """After log2(D) XOR-partner rounds every participant holds the
        exact top-N of all D partials."""
        sa, ia = random_partials(np.random.default_rng(D), B=8, D=D,
                                 topn=TOPN, tie_prob=0.2, empty_prob=0.2)
        parts = [(_t(s), _t(i)) for s, i in zip(sa, ia)]
        k = 1
        while k < D:
            parts = [merge_topn(*parts[d], *parts[d ^ k], topn=TOPN)
                     for d in range(D)]
            k *= 2
        ref_s, ref_i = merged_oracle(sa, ia, TOPN)
        for d in range(D):
            assert_topn_equal(parts[d][0], parts[d][1], ref_s, ref_i)

    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 10_000), st.integers(2, 6), st.integers(1, 12))
    def test_property_random_splits(self, seed, D, topn):
        sa, ia = random_partials(np.random.default_rng(seed), B=4, D=D,
                                 topn=topn, tie_prob=0.3, empty_prob=0.3)
        acc = (_t(sa[0]), _t(ia[0]))
        for d in range(1, D):
            acc = merge_topn(*acc, _t(sa[d]), _t(ia[d]), topn=topn)
        assert_topn_equal(acc[0], acc[1], *merged_oracle(sa, ia, topn))


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_catalog():
    """The JAX suite's catalog: (port sp, JAX sp, sigs numpy, counts)."""
    rng = np.random.default_rng(0)
    M, N, deg = 200, 300, 8
    rows = np.repeat(np.arange(M), deg)
    cols = rng.integers(0, N, M * deg)
    vals = rng.uniform(1, 5, M * deg).astype(np.float32)
    order = np.lexsort((cols, rows))
    jsp = jfrom_coo(rows[order], cols[order], vals[order], (M, N))
    sigs = np.array(jsim.encode(jsp, jsim.SimLSHConfig(G=4, p=2, q=4),
                                jax.random.PRNGKey(0)))
    sp = from_coo(rows[order], cols[order], vals[order], (M, N),
                  device="cpu")
    counts = np.bincount(np.asarray(jsp.cols), minlength=N)
    return sp, jsp, sigs, counts


@pytest.fixture(scope="module")
def sharded4(small_catalog):
    _, _, sigs, counts = small_catalog
    bounds = shard_bounds(counts, 4)
    return (build_sharded_index(torch.from_numpy(sigs), shards=4,
                                bounds=bounds),
            jbuild_sharded(jnp.asarray(sigs), shards=4, bounds=bounds))


IDX_FIELDS = ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
              "slot_of", "n_local", "bounds")


class TestShardedIndex:
    @pytest.mark.parametrize("D", [1, 2, 4, 8])
    def test_shard_bounds_cover_monotone_and_equal_jax(self, small_catalog,
                                                       D):
        counts = small_catalog[3]
        b = shard_bounds(counts, D)
        assert b[0] == 0 and b[-1] == counts.size
        assert np.all(np.diff(b) > 0)
        np.testing.assert_array_equal(b, jshard_bounds(counts, D))

    def test_shard_bounds_nnz_balanced(self, small_catalog):
        counts = small_catalog[3]
        b = shard_bounds(counts, 4)
        per = [counts[b[d]:b[d + 1]].sum() for d in range(4)]
        naive = [counts[i * 75:(i + 1) * 75].sum() for i in range(4)]
        assert max(per) <= max(naive)

    def test_build_equals_jax(self, sharded4):
        got, want = sharded4
        for f in IDX_FIELDS:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          np.asarray(getattr(want, f)), f)
        assert (got.n_items, got.block) == (want.n_items, want.block)

    def test_geometry(self, sharded4, small_catalog):
        idx = sharded4[0]
        sigs = small_catalog[2]
        assert idx.shards == 4 and idx.q == sigs.shape[0]
        assert idx.n_items == sigs.shape[1]
        nl = idx.n_local.numpy()
        assert nl.sum() == idx.n_items and nl.max() == idx.block
        assert tuple(idx.sorted_sigs.shape) == (4, idx.q, idx.block)

    def test_validate_sharded_index_clean(self, sharded4):
        assert validate_sharded_index(sharded4[0]) == []
        assert jvalidate_sharded(sharded4[1]) == []

    def test_validate_index_dispatches_on_sharded(self, sharded4):
        assert validate_index(sharded4[0]) == []

    @pytest.mark.parametrize("corrupt", ["duplicate_id", "bad_bounds",
                                         "bad_n_local", "bad_padding"])
    def test_validate_sharded_index_catches_corruption(self, sharded4,
                                                       corrupt):
        """Each corruption refused, with the JAX package's verdicts."""
        got, want = sharded4
        if corrupt == "duplicate_id":
            field = "sorted_ids"
            bad = got.sorted_ids.numpy().copy()
            bad[1, 0, :2] = bad[1, 0, 0]       # a duplicate local id
        elif corrupt == "bad_bounds":
            field = "bounds"
            bad = got.bounds.numpy().copy()
            bad[1] = bad[2]                     # a zero-width shard
        elif corrupt == "bad_n_local":
            field = "n_local"
            bad = got.n_local.numpy().copy()
            bad[0] += 1
        else:                                    # a real signature as pad
            field = "sorted_sigs"
            bad = got.sorted_sigs.numpy().copy()
            d = int(np.argmin(got.n_local.numpy()))
            bad[d, :, 0] = int(bad[d, :, -1].min())
        probs = validate_sharded_index(dataclasses.replace(
            got, **{field: torch.from_numpy(bad)}))
        jprobs = jvalidate_sharded(dataclasses.replace(
            want, **{field: jnp.asarray(bad)}))
        assert probs and probs == jprobs
        if corrupt == "duplicate_id":
            assert any("shard 1" in p for p in probs)
        if corrupt == "bad_bounds":
            assert any("strictly increasing" in p for p in probs)

    def test_local_ids_partition_catalog(self, sharded4):
        idx = sharded4[0]
        bounds, nl = idx.bounds.numpy(), idx.n_local.numpy()
        seen = []
        for d in range(4):
            ids = idx.sorted_ids[d, 0].numpy()
            real = ids[ids < nl[d]]
            assert np.array_equal(np.sort(real), np.arange(nl[d]))
            seen.append(real + bounds[d])
        assert np.array_equal(np.sort(np.concatenate(seen)),
                              np.arange(idx.n_items))

    def test_bucket_membership_roundtrips(self, sharded4, small_catalog):
        """Per band, an item's local bucket is the single-device bucket ∩
        the shard."""
        idx = sharded4[0]
        sigs = small_catalog[2]
        bounds, nl = idx.bounds.numpy(), idx.n_local.numpy()
        for d in range(4):
            view = shard_local_view(idx, d)
            ss, si = view.sorted_sigs.numpy(), view.sorted_ids.numpy()
            lo_, hi_ = view.bucket_lo.numpy(), view.bucket_hi.numpy()
            so = view.slot_of.numpy()
            for b in range(idx.q):
                for g in range(bounds[d], bounds[d + 1]):
                    slot = so[b, g - bounds[d]]
                    assert ss[b, slot] == sigs[b, g]
                    members = si[b, lo_[b, slot]:hi_[b, slot]]
                    members = members[members < nl[d]] + bounds[d]
                    ref = np.flatnonzero(sigs[b] == sigs[b, g])
                    ref = ref[(ref >= bounds[d]) & (ref < bounds[d + 1])]
                    assert np.array_equal(np.sort(members), ref), (d, b, g)

    def test_padding_slots_inert(self, sharded4):
        idx = sharded4[0]
        ss, nl = idx.sorted_sigs.numpy(), idx.n_local.numpy()
        for d in range(4):
            n_pad = idx.block - nl[d]
            assert np.all((ss[d] == _EMPTY_SIG).sum(axis=1) == n_pad)
            if n_pad:
                assert np.all(ss[d, :, :n_pad] == _EMPTY_SIG)

    def test_shard_col_plane_equals_jax_and_round_trips(self, sharded4):
        bounds = sharded4[0].bounds.numpy()
        col = np.random.default_rng(0).normal(size=(300, 5)).astype(
            np.float32)
        stack = shard_col_plane(torch.from_numpy(col), bounds)
        np.testing.assert_array_equal(
            stack.numpy(), np.asarray(jmodel.shard_col_plane(
                jnp.asarray(col), bounds)))
        assert torch.equal(unshard_col_plane(stack, bounds),
                           torch.from_numpy(col))

    def test_single_shard_equals_plain_index(self, small_catalog):
        sigs = torch.from_numpy(small_catalog[2])
        plain = build_index(sigs, tail_cap=0, device="cpu")
        view = shard_local_view(build_sharded_index(sigs, shards=1), 0)
        for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
                  "slot_of"):
            assert torch.equal(getattr(view, f), getattr(plain, f)), f

    def test_signatures_of_roundtrip(self, small_catalog):
        sigs = torch.from_numpy(small_catalog[2])
        idx = build_index(sigs, tail_cap=0, device="cpu")
        assert torch.equal(signatures_of(idx), sigs)

    def test_build_guards(self, small_catalog):
        sigs = torch.from_numpy(small_catalog[2])
        with pytest.raises(TypeError):
            build_sharded_index(sigs.float(), shards=2)
        with pytest.raises(ValueError):
            build_sharded_index(sigs, shards=0)
        with pytest.raises(ValueError):
            build_sharded_index(sigs, shards=2,
                                bounds=np.asarray([0, 200, 150, 300]))
        with pytest.raises(ValueError):
            build_sharded_index(sigs, shards=2, bounds=np.asarray([0, 300]))


# ---------------------------------------------------------------------------
# the shard-local walk, bit-equal to the JAX functions
# ---------------------------------------------------------------------------

def _seeds(small_catalog, n_users, n_seeds=4):
    sp, jsp = small_catalog[:2]
    users = np.arange(n_users, dtype=np.int32)
    seeds = seed_items(sp, torch.from_numpy(users), n_seeds=n_seeds,
                       window=32)
    jseeds = jret.seed_items(jsp, jnp.asarray(users), n_seeds=n_seeds,
                             window=32)
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    return seeds


def _contribs(idx, seeds):
    bounds, nl = idx.bounds.numpy(), idx.n_local.numpy()
    return [shard_seed_sigs(idx.sorted_sigs[d], idx.slot_of[d], seeds,
                            int(bounds[d]), int(nl[d])) for d in range(4)]


def _qsigs(idx, seeds):
    total = mesh.psum(_contribs(idx, seeds))[0]
    return torch.where((seeds != SENTINEL)[None], total,
                       torch.full_like(total, _EMPTY_SIG))


class TestShardWalk:
    CAP, BUDGET = 512, 2048        # truncation-free: parity is exact

    def test_seed_sig_exchange_sums_to_truth(self, small_catalog, sharded4):
        idx, jidx = sharded4
        seeds = _seeds(small_catalog, 32)
        bounds, nl = idx.bounds.numpy(), idx.n_local.numpy()
        contribs = _contribs(idx, seeds)
        for d in range(4):
            want = jseed_sigs(jidx.sorted_sigs[d], jidx.slot_of[d],
                              jnp.asarray(seeds.numpy()), int(bounds[d]),
                              int(nl[d]))
            np.testing.assert_array_equal(contribs[d].numpy(),
                                          np.asarray(want))
        total = sum(c.numpy().astype(np.int64) for c in contribs)
        sigs, s = small_catalog[2], seeds.numpy()
        valid = s != SENTINEL
        np.testing.assert_array_equal(total[:, valid],
                                      sigs[:, np.where(valid, s, 0)][:,
                                                                     valid])
        assert np.all(total[:, ~valid] == 0)

    def test_seed_sig_exchange_disjoint_owners(self, small_catalog,
                                               sharded4):
        seeds = _seeds(small_catalog, 16)
        owners = sum(np.any(c.numpy() != 0, axis=0).astype(np.int32)
                     for c in _contribs(sharded4[0], seeds))
        valid = seeds.numpy() != SENTINEL
        assert np.all(owners[valid] <= 1) and np.all(owners[~valid] == 0)

    def test_psum_and_ppermute_copy_never_alias(self):
        parts = [torch.full((3,), float(d)) for d in range(4)]
        summed = mesh.psum(parts)
        assert all(torch.equal(s, torch.full((3,), 6.0)) for s in summed)
        assert len({s.data_ptr() for s in summed}) == 4
        rot = mesh.ppermute(parts, [(i, (i - 1) % 4) for i in range(4)])
        assert [float(r[0]) for r in rot] == [1.0, 2.0, 3.0, 0.0]
        assert not {r.data_ptr() for r in rot} & {p.data_ptr()
                                                  for p in parts}
        half = mesh.ppermute(parts, [(0, 1)])      # unsent shards get zeros
        assert float(half[1][0]) == 0.0 and float(half[0][0]) == 0.0

    @pytest.mark.parametrize("cap,budget", [(512, 2048), (8, 64), (2, 24)])
    def test_walk_and_descriptors_equal_jax(self, small_catalog, sharded4,
                                            cap, budget):
        idx, jidx = sharded4
        seeds = _seeds(small_catalog, 48)
        qsigs = _qsigs(idx, seeds)
        jq = jnp.asarray(qsigs.numpy())
        nl = idx.n_local.numpy()
        for d in range(4):
            (st_, ct), (jst, jct) = (
                sig_window_descriptors(idx.sorted_sigs[d], qsigs, cap=cap),
                jret.sig_window_descriptors(jidx.sorted_sigs[d], jq,
                                            cap=cap))
            st_, ct, jst, jct = (_np(x) for x in (st_, ct, jst, jct))
            # the windows the walk reads, in order (an empty window's
            # start may tie a bucket's, and the two sorts order such a
            # tie differently: see `sig_window_descriptors`)
            for u in range(ct.shape[0]):
                live, jlive = ct[u] > 0, jct[u] > 0
                np.testing.assert_array_equal(st_[u][live], jst[u][jlive])
                np.testing.assert_array_equal(ct[u][live], jct[u][jlive])
            local = shard_walk_local(idx.sorted_sigs[d], idx.sorted_ids[d],
                                     qsigs, int(nl[d]), cap=cap,
                                     budget=budget)
            jlocal = jwalk_local(jidx.sorted_sigs[d], jidx.sorted_ids[d],
                                 jq, int(nl[d]), cap=cap, budget=budget)
            np.testing.assert_array_equal(local.numpy(), np.asarray(jlocal))

    def test_union_parity_with_single_device_walk(self, small_catalog,
                                                  sharded4):
        idx = sharded4[0]
        sp, sigs = small_catalog[0], small_catalog[2]
        seeds = _seeds(small_catalog, 48)
        qsigs = _qsigs(idx, seeds)
        bounds, nl = idx.bounds.numpy(), idx.n_local.numpy()
        got = [set() for _ in range(48)]
        for d in range(4):
            local = shard_walk_local(idx.sorted_sigs[d], idx.sorted_ids[d],
                                     qsigs, int(nl[d]), cap=self.CAP,
                                     budget=self.BUDGET)
            glob = translate_local_ids(local, int(bounds[d])).numpy()
            for u in range(48):
                got[u] |= set(glob[u][glob[u] != SENTINEL].tolist())
        plain = build_index(torch.from_numpy(sigs), tail_cap=0, device="cpu")
        ids, _ = walk_candidates(plain, sp, torch.arange(48,
                                                         dtype=torch.int32),
                                 n_seeds=4, cap=self.CAP, budget=self.BUDGET,
                                 window=32)
        for u in range(48):
            assert got[u] == set(ids[u][ids[u] != SENTINEL].tolist()), u

    def test_walk_never_emits_padding_or_foreign_ids(self, small_catalog,
                                                     sharded4):
        idx = sharded4[0]
        qsigs = _qsigs(idx, _seeds(small_catalog, 32))
        for d in range(4):
            n = int(idx.n_local[d])
            local = shard_walk_local(idx.sorted_sigs[d], idx.sorted_ids[d],
                                     qsigs, n, cap=8, budget=64).numpy()
            real = local[local != SENTINEL]
            assert np.all((real >= 0) & (real < n))

    def test_empty_sig_probes_retrieve_nothing(self, sharded4):
        idx = sharded4[0]
        qsigs = torch.full((idx.q, 4, 4), _EMPTY_SIG, dtype=torch.int32)
        local = shard_walk_local(idx.sorted_sigs[0], idx.sorted_ids[0],
                                 qsigs, int(idx.n_local[0]), cap=8,
                                 budget=64)
        assert bool((local == SENTINEL).all())

    def test_translate_local_ids(self):
        local = np.asarray([[0, 5, SENTINEL], [SENTINEL, 2, 1]], np.int32)
        out = translate_local_ids(torch.from_numpy(local), 100).numpy()
        np.testing.assert_array_equal(
            out, [[100, 105, SENTINEL], [SENTINEL, 102, 101]])
        np.testing.assert_array_equal(
            out, np.asarray(jtranslate(jnp.asarray(local), 100)))


# ---------------------------------------------------------------------------
# config: the JAX package's resolution at the same device count
# ---------------------------------------------------------------------------

class TestShardConfig:
    @pytest.mark.parametrize("request_", [0, 1, 2, 4, "auto", 3, 8])
    def test_serve_shard_count_equals_jax(self, monkeypatch, request_):
        """The JAX process here has one device; the port without the
        setting has one too, and with 4 logical devices it resolves as
        the JAX package's 4-device checks do."""
        def resolve(fn, *a):
            try:
                return fn(request_, *a)
            except ValueError as e:
                return str(e)
        assert jax.device_count() == 1
        assert resolve(mesh.serve_shard_count, "cpu") == resolve(
            jmesh.serve_shard_count)
        monkeypatch.setenv(mesh.LOGICAL_DEVICES, "4")
        want = {0: 1, 1: 1, 2: 2, 4: 4, "auto": 4}.get(request_)
        got = resolve(mesh.serve_shard_count, "cpu")
        assert got == want if want else "exceeds the 4" in got or \
            "power of two" in got

    def test_resolved_shard_budget_equals_jax(self):
        for budget in (0, 64, 512, 768, 16384):
            for shard_budget in (0, 96):
                t = ServeConfig(band_budget=budget, shard_budget=shard_budget)
                j = JConfig(band_budget=budget, shard_budget=shard_budget)
                for D in (1, 2, 4, 8, 16):
                    assert (t.resolved_shard_budget(D)
                            == j.resolved_shard_budget(D))
        assert ServeConfig(band_budget=512).resolved_shard_budget(4) == 256
        assert ServeConfig(band_budget=768).resolved_shard_budget(4) == 384

    def test_mesh_logical_and_refusals(self, monkeypatch):
        monkeypatch.delenv(mesh.LOGICAL_DEVICES, raising=False)
        assert mesh.device_count("cpu") == 1
        assert mesh.make_shard_mesh(1, "cpu").devices == (
            torch.device("cpu"),)
        with pytest.raises(ValueError, match="exceeds"):
            mesh.make_shard_mesh(2, "cpu")
        monkeypatch.setenv(mesh.LOGICAL_DEVICES, "4")
        assert mesh.device_count("cpu") == 4
        m = mesh.make_shard_mesh(4, "cpu")
        assert m.size == 4 and set(m.devices) == {torch.device("cpu")}
        with pytest.raises(ValueError, match="exceeds"):
            mesh.make_shard_mesh(8, "cpu")
        monkeypatch.setenv(mesh.LOGICAL_DEVICES, "0")
        with pytest.raises(ValueError, match="≥ 1"):
            mesh.device_count("cpu")


# ---------------------------------------------------------------------------
# the whole flush on the check_sharded_serve catalog
# ---------------------------------------------------------------------------

REGIME1 = dict(topn=10, micro_batch=128, n_seeds=8, cap=4096,
               band_budget=16384, shard_budget=16384, n_popular=0,
               use_jk=False)
BENCH = dict(topn=10, micro_batch=128, C=512, n_seeds=16, cap=8,
             n_popular=64, tile_b=16, band_budget=512)


@pytest.fixture(scope="module")
def catalog():
    """The JAX check's catalog, index and J^K, and the port's copies."""
    params, jsp, _ = make_catalog(CatalogSpec(N=4000), seed=0)
    lsh = jsim.SimLSHConfig(G=8, p=2, q=10, band_cap=16)
    key = jax.random.PRNGKey(0)
    sigs = jsim.encode(jsp, lsh, key)
    jJK = jtopk.topk_from_signatures(sigs, jax.random.fold_in(key, 1), K=16,
                                     band_cap=lsh.band_cap)
    jindex = jbuild(sigs, tail_cap=0)
    tp = convert.params_from_numpy(*(np.asarray(getattr(params, f)) for f in
                                     ("U", "V", "b", "bh", "W", "C", "mu")),
                                   device="cpu")
    tsp = convert.sparse_from_numpy(np.asarray(jsp.rows),
                                    np.asarray(jsp.cols),
                                    np.asarray(jsp.vals), jsp.shape,
                                    device="cpu")
    tindex = convert.index_from_numpy(np.asarray(sigs), tail_cap=0,
                                      device="cpu")
    users = np.random.default_rng(1).integers(
        0, params.U.shape[0], 128).astype(np.int32)
    return dict(jparams=params, jsp=jsp, jindex=jindex, jJK=jJK, tp=tp,
                tsp=tsp, tindex=tindex, JK=torch.from_numpy(np.array(jJK)),
                users=users)


def _service(cat, **kw):
    with logical(4):
        return RecsysService(cat["tp"], cat["tindex"], cat["tsp"],
                             ServeConfig(**kw), JK=cat["JK"], device="cpu")


def _jax_sharded_flush(cat, cfg: JConfig, D: int):
    """The JAX package's sharded flush composed shard by shard from its
    per-shard functions: a sum for the psum, `merge_topn` for each
    butterfly round."""
    planes = jmodel.pack_serve_planes(cat["jparams"])
    jsp, F = cat["jsp"], planes.F
    counts = np.bincount(np.asarray(jsp.cols), minlength=planes.n_items)
    bounds = jshard_bounds(counts, D)
    sidx = jbuild_sharded(jsignatures_of(cat["jindex"]), shards=D,
                          bounds=bounds)
    col_stack = jmodel.shard_col_plane(planes.col, bounds)
    users = jnp.asarray(cat["users"])
    seeds = jret.seed_items(jsp, users, n_seeds=cfg.n_seeds,
                            window=cfg.seed_window)
    urow = planes.row[users].at[:, F].add(planes.mu)
    nl = np.asarray(sidx.n_local)
    qsigs = sum(jseed_sigs(sidx.sorted_sigs[d], sidx.slot_of[d], seeds,
                           int(bounds[d]), int(nl[d])) for d in range(D))
    qsigs = jnp.where((seeds != SENTINEL)[None], qsigs, _EMPTY_SIG)
    popular = (jsvc.popular_shortlist(cat["jparams"], cfg.n_popular)
               if cfg.n_popular else None)
    parts = []
    for d in range(D):
        local = jwalk_local(sidx.sorted_sigs[d], sidx.sorted_ids[d], qsigs,
                            int(nl[d]), cap=cfg.cap,
                            budget=cfg.resolved_shard_budget(D))
        if popular is not None:
            pl = popular - int(bounds[d])
            pl = jnp.where((pl >= 0) & (pl < int(nl[d])), pl, SENTINEL)
            local = jnp.concatenate(
                [local, jnp.broadcast_to(pl[None], (local.shape[0],
                                                    pl.shape[0]))], axis=1)
        s = jsvc._pool_scores(urow, col_stack[d], local,
                              tile_b=cfg.walk_tile_b)
        parts.append(jsvc._select_topn_masked(
            s, jtranslate(local, int(bounds[d])), topn=cfg.topn))
    k = 1
    while k < D:
        parts = [jmerge(*parts[d], *parts[d ^ k], topn=cfg.topn)
                 for d in range(D)]
        k *= 2
    return parts[0]


def _top_sets(s, i):
    s, i = _np(s), _np(i)
    return [(frozenset(i[u][i[u] != SENTINEL].tolist()),
             np.sort(s[u][i[u] != SENTINEL])) for u in range(i.shape[0])]


@pytest.mark.parametrize("settings_", ["bench", "regime1"])
def test_sharded_flush_equals_jax_composition(catalog, settings_):
    kw = BENCH if settings_ == "bench" else REGIME1
    svc = _service(catalog, **kw, shards=4)
    got_s, got_i = svc._recommend(torch.from_numpy(catalog["users"]))
    want_s, want_i = _jax_sharded_flush(catalog, JConfig(**kw), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("D", [2, 4])
def test_regime1_equals_single_device_walks(catalog, D):
    """With nothing truncated every probed bucket is enumerated whole, so
    the sharded top-N id sets equal the single-device walks' — the
    port's ``impl="ref"`` service and the JAX `recommend_walked`."""
    users = torch.from_numpy(catalog["users"])
    sharded = _service(catalog, **REGIME1, shards=D)
    assert sharded.stats()["shards"] == D
    single = _service(catalog, **REGIME1, impl="ref")
    jsvc_ = JService(catalog["jparams"], catalog["jindex"], catalog["jsp"],
                     JConfig(**REGIME1))
    pairs = zip(_top_sets(*sharded._recommend(users)),
                _top_sets(*single._recommend(users)),
                _top_sets(*jsvc_._recommend(jnp.asarray(catalog["users"]))))
    for (ids_a, s_a), (ids_b, s_b), (ids_c, s_c) in pairs:
        assert ids_a == ids_b == ids_c, (sorted(ids_a ^ ids_b))
        np.testing.assert_allclose(s_a, s_b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s_a, s_c, rtol=1e-5, atol=1e-5)


def test_regime2_recall_within_the_jax_gate(catalog):
    users = catalog["users"]
    _, exact = full_topn(catalog["tp"], torch.from_numpy(users), topn=10)
    exact = exact.numpy()

    def recall(svc):
        svc.submit(users)
        svc.flush()
        got = np.concatenate([r[2] for r in svc.take_results()])
        return sum(len(set(g) & set(e))
                   for g, e in zip(got, exact)) / exact.size

    rec_s = recall(_service(catalog, **BENCH, shards=4))
    rec_1 = recall(_service(catalog, **BENCH, impl="ref"))
    assert rec_s >= rec_1 - 0.01, (rec_s, rec_1)


# ---------------------------------------------------------------------------
# the service around the sharded flush
# ---------------------------------------------------------------------------

def test_sharded_service_is_read_only(catalog):
    svc = _service(catalog, **BENCH, shards=4)
    sigs = signatures_of(svc.index)
    N = sigs.shape[1]
    with pytest.raises(ShardedIngestUnsupported, match="read-only"):
        svc.ingest(sigs[:, :1], torch.tensor([N], dtype=torch.int32),
                   full_sigs=sigs)
    with pytest.raises(ShardedIngestUnsupported):
        svc.ingest_online_update(object(), N)
    with pytest.raises(ShardedIngestUnsupported):
        svc.request_rebuild(sigs)
    assert isinstance(ShardedIngestUnsupported("x"), NotImplementedError)
    assert svc.stats()["ingest_rejected"] == 3
    assert svc.index.tail_fill == 0 and svc._rebuilder is None


def test_sharded_service_refusals_at_construction(catalog):
    with pytest.raises(ValueError, match="band_budget > 0"):
        _service(catalog, **dict(BENCH, band_budget=0), shards=4)
    tail = convert.index_from_numpy(
        signatures_of(catalog["tindex"]).numpy(), tail_cap=8, device="cpu")
    from repro_torch.serve import insert
    tail = insert(tail, signatures_of(catalog["tindex"])[:, :1],
                  torch.tensor([4000], dtype=torch.int32))
    with logical(4), pytest.raises(ValueError, match="empty index tail"):
        RecsysService(catalog["tp"], tail, catalog["tsp"],
                      ServeConfig(**BENCH, shards=4), device="cpu")
    with pytest.raises(ValueError, match="exceeds the 1"):
        RecsysService(catalog["tp"], catalog["tindex"], catalog["tsp"],
                      ServeConfig(**BENCH, shards=2), device="cpu")
    full = _service(catalog, **BENCH, shards=4, mode="full")
    assert full._shard_state is None and full.stats()["shards"] == 1


def test_sharded_stats_profile_and_no_kernel(catalog):
    """`stats()["shards"]`, the JAX service's span names for the sharded
    branch, the staged answer equal to the flush's, `validate_index` on
    the tier's index clean, and no serving kernel counted."""
    svc = _service(catalog, **BENCH, shards=4)
    users = catalog["users"][:64]
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    svc.submit(users)
    svc.flush()
    _, s_f, i_f = svc.take_results()[0]
    secs = svc.profile_flush(users)
    assert list(secs) == ["serve.flush", "serve.flush.sharded"]
    np.testing.assert_array_equal(svc.profiled[1].numpy(), i_f)
    np.testing.assert_array_equal(svc.profiled[0].numpy(), s_f)
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before
    st_ = svc.stats()
    assert st_["shards"] == 4 and st_["fallbacks"] == 0
    assert validate_index(svc._shard_state.index) == []
    jsvc_ = JService(catalog["jparams"], catalog["jindex"], catalog["jsp"],
                     JConfig(**BENCH))
    # pose as the JAX tier (its flush needs four devices): the branch's
    # spans are what is compared
    stack = SimpleNamespace(sorted_sigs=None, sorted_ids=None, slot_of=None,
                            n_local=None, bounds=None)
    jsvc_._shard_state = (stack, None, None, 4)
    jsvc_._sharded_fn = lambda *a: jsvc.full_topn(
        catalog["jparams"], a[-2], topn=10)
    assert list(jsvc_.profile_flush(users)) == list(secs)
