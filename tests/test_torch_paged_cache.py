"""The port's paged store against ``repro.serving.paged_cache``: the host
allocator and block tables case for case, and the device primitives on
the same numpy inputs (exact: they only move values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import paged_cache as jpc
from repro_torch.serving import paged_cache as tpc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mod", [jpc, tpc], ids=["reference", "port"])
def test_pool_alloc_free_roundtrip(mod):
    pool = mod.PagePool(4)
    assert pool.free_count == 4
    a = pool.alloc(3)
    assert len(set(a)) == 3 and 0 not in a       # unique, never garbage
    assert pool.free_count == 1
    pool.free(a[:2])
    assert pool.free_count == 3
    b = pool.alloc(3)
    assert 0 not in b and pool.free_count == 0
    assert set(b) & set(a[:2])                    # freed pages recycle


def test_pool_sequences_match_reference():
    """The same calls hand out the same page ids in the same order."""
    ops = [("alloc", 3), ("free", [2]), ("alloc", 2), ("share", [1]),
           ("free", [1]), ("alloc", 1), ("free", [1, 3]), ("alloc", 3)]
    pools = [jpc.PagePool(6), tpc.PagePool(6)]
    for op, arg in ops:
        outs = [getattr(p, op)(arg) for p in pools]
        assert outs[0] == outs[1], (op, arg)
        assert [p.free_count for p in pools] == [pools[0].free_count] * 2
        assert [p.ref(1) for p in pools] == [pools[0].ref(1)] * 2


def test_pool_exhaustion_allocates_nothing():
    pool = tpc.PagePool(2)
    pool.alloc(1)
    with pytest.raises(tpc.PagePoolExhausted):
        pool.alloc(2)
    assert pool.free_count == 1                   # failed alloc took none


def test_pool_double_free_and_garbage_guard():
    pool = tpc.PagePool(2)
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free(pages)
    with pytest.raises(ValueError):
        pool.free([tpc.GARBAGE_PAGE])
    with pytest.raises(ValueError):
        pool.share([tpc.GARBAGE_PAGE])


def test_pool_refcounts_recycle_at_zero():
    pool = tpc.PagePool(3)
    (p,) = pool.alloc(1)
    pool.share([p])
    pool.free([p])
    assert pool.ref(p) == 1 and pool.used_count == 1
    pool.free([p])
    assert pool.ref(p) == 0 and pool.used_count == 0


@pytest.mark.parametrize("mod", [jpc, tpc], ids=["reference", "port"])
def test_pool_watermarks(mod):
    pool = mod.PagePool(10, high_watermark=0.8, low_watermark=0.2)
    assert pool.high_pages == 8 and pool.low_extra == 2
    pool.alloc(7)
    assert pool.can_admit(1)              # 7 + 1 <= 8
    assert not pool.can_admit(2)          # would cross the high watermark
    full = mod.PagePool(4)
    assert full.high_pages == 4 and full.low_extra == 0
    full.alloc(3)
    assert full.can_admit(1) and not full.can_admit(2)


@pytest.mark.parametrize("n,ps", [(0, 8), (1, 8), (8, 8), (9, 8), (17, 4),
                                  (-3, 4)])
def test_pages_needed(n, ps):
    assert tpc.pages_needed(n, ps) == jpc.pages_needed(n, ps)


def test_block_tables_export_non_live_rows_as_garbage():
    pool = tpc.PagePool(8)
    jt = jpc.BlockTables(3, 4)
    tt = tpc.BlockTables(3, 4, torch.device("cpu"))
    for t in (jt, tt):
        t.assign(0, [5, 2])
        t.assign(1, [7])
        t.assign(1, [3], start=1)
    live = np.array([True, False, True])
    np.testing.assert_array_equal(tt.device(live).numpy(),
                                  np.asarray(jt.device(live)))
    assert tt.device(live).dtype == torch.int32
    assert (tt.device(live).numpy()[1] == tpc.GARBAGE_PAGE).all()
    np.testing.assert_array_equal(tt.device().numpy(),
                                  np.asarray(jt.device()))
    first = tt.device(live)
    assert tt.device(live) is first               # cached until rows move
    pool.alloc(8)
    tt.release(0, pool)
    assert tt.device(live) is not first
    assert (tt.device(live).numpy()[0] == tpc.GARBAGE_PAGE).all()
    assert pool.free_count == 2


def _pool(rng, P=7, Hkv=2, ps=4, R=5):
    return rng.normal(size=(P, Hkv, ps, R)).astype(np.float32)


def test_append_token_matches_reference():
    rng = np.random.default_rng(0)
    pool = _pool(rng)
    btab = np.array([[3, 1, 0], [2, 6, 4], [0, 0, 0]], np.int32)
    pos = np.array([5, 9, 2])
    val = rng.normal(size=(3, 2, 5)).astype(np.float32)
    want = jpc.append_token(jnp.asarray(pool), jnp.asarray(btab),
                            jnp.asarray(pos), jnp.asarray(val))
    got = tpc.append_token(torch.from_numpy(pool.copy()),
                           torch.from_numpy(btab), torch.from_numpy(pos),
                           torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["mask", "count"])
def test_append_chunk_matches_reference(form):
    """Both ``valid`` forms; padding goes to the garbage page, real pages
    past the valid prefix keep their values."""
    rng = np.random.default_rng(1)
    B, Hkv, ps, n_pages, R, S = 2, 2, 4, 3, 8, 6
    pool = np.full((1 + B * n_pages, Hkv, ps, R), -1.0, np.float32)
    btab = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos0 = np.array([2, 0], np.int32)
    n_valid = np.array([3, 6], np.int32)
    vals = rng.normal(size=(B, Hkv, S, R)).astype(np.float32)
    mask = np.arange(S)[None, :] < n_valid[:, None]
    valid = mask if form == "mask" else n_valid
    want = jpc.append_chunk(jnp.asarray(pool), jnp.asarray(btab),
                            jnp.asarray(pos0), jnp.asarray(vals),
                            jnp.asarray(valid))
    got = tpc.append_chunk(torch.from_numpy(pool.copy()),
                           torch.from_numpy(btab), torch.from_numpy(pos0),
                           torch.from_numpy(vals), torch.from_numpy(valid))
    # the garbage page takes duplicate padding writes in an unspecified
    # order: compare the real pages exactly
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    seq = tpc.gather_pages(got, torch.from_numpy(btab)).numpy()
    assert (seq[0, :, 2 + 3:] == -1.0).all()
    assert (got.numpy()[tpc.GARBAGE_PAGE] != -1.0).any()


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(2)
    pool = _pool(rng)
    btab = np.array([[3, 1, 5], [6, 0, 2]], np.int32)
    want = jpc.gather_pages(jnp.asarray(pool), jnp.asarray(btab))
    got = tpc.gather_pages(torch.from_numpy(pool), torch.from_numpy(btab))
    assert tuple(got.shape) == (2, 2, 12, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_copy_page_matches_reference():
    rng = np.random.default_rng(3)
    pool = _pool(rng)
    want = jpc.copy_page(jnp.asarray(pool), 2, 5)
    got = tpc.copy_page(torch.from_numpy(pool.copy()), 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[5] == pool[2]).all()


@pytest.mark.parametrize("n_tokens", [1, 3, 4, 5, 11])
def test_swap_round_trip_matches_reference(n_tokens):
    """``swap_out`` reads the reference's bytes, ``swap_in`` writes them
    back through a fresh row as the reference does, and the round trip
    restores the slot's entries exactly (page size 4)."""
    rng = np.random.default_rng(n_tokens)
    pool = _pool(rng, P=9)
    row = np.array([3, 7, 1, 0], np.int32)
    want = np.asarray(jpc.swap_out(jnp.asarray(pool), row, n_tokens))
    got = tpc.swap_out(torch.from_numpy(pool), row, n_tokens)
    assert got.device.type == "cpu" and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    fresh = np.array([5, 2, 8, 6], np.int32)
    dst = np.full_like(pool, -1.0)
    jin = np.asarray(jpc.swap_in(jnp.asarray(dst), fresh, want))
    tin = tpc.swap_in(torch.from_numpy(dst.copy()), fresh, got).numpy()
    np.testing.assert_array_equal(tin[1:], jin[1:])
    back = tpc.gather_pages(torch.from_numpy(tin),
                            torch.from_numpy(fresh[None]))[0, :, :n_tokens]
    np.testing.assert_array_equal(back.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.uint8])
def test_swap_round_trip_is_byte_exact_in_page_dtypes(dtype):
    """bf16 pages, int8 codes and packed uint8 leaves round-trip bit for
    bit, and the buffer's checksum is the reference's crc32 over its
    bytes."""
    from repro.serving.faults import checksum as jax_checksum
    from repro_torch.serving.faults import checksum
    g = torch.Generator().manual_seed(0)
    pool = (torch.randn(9, 2, 4, 6, generator=g) * 50).to(dtype)
    buf = tpc.swap_out(pool, np.array([4, 2, 0], np.int32), 7)
    dst = torch.zeros_like(pool)
    tpc.swap_in(dst, np.array([8, 1, 0], np.int32), buf)
    assert torch.equal(dst[8], pool[4])
    assert torch.equal(dst[1, :, :3], pool[2, :, :3])
    raw = buf.view(torch.uint8).numpy()
    assert checksum([{"k": buf}]) == jax_checksum([{"k": raw}])


def test_set_page_clears_the_device_export():
    """A copy-on-write fork or late match rewrites a row entry: the next
    export carries the new page, so no kernel reads the old one."""
    tt = tpc.BlockTables(2, 4, torch.device("cpu"))
    tt.assign(0, [5, 2, 7])
    tt.assign(1, [3])
    live = np.array([True, True])
    first = tt.device(live)
    tt.set_page(0, 1, 6)
    second = tt.device(live)
    assert second is not first
    assert second[0].tolist() == [5, 6, 7, 0] and tt.slot_pages[0][1] == 6
    assert first[0, 1] == 2                       # the old export is stale
    with pytest.raises(AssertionError):
        tt.set_page(1, 1, 4)                      # past the slot's pages
