"""K1 and K2 in the port: their plain PyTorch versions against the
reference's jnp oracles on the reference's shape cases (scrambled block
tables, page-boundary lengths, chunks at pos0 0, page-aligned and
mid-page) and against its Pallas kernels in interpret mode; the wrappers'
CPU routing; and a lazy build (the module imports where there is no
nvcc)."""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kq_decode import (kq_decode_paged_attention_op,
                                     kq_decode_paged_attention_ref,
                                     kq_prefill_paged_attention_op,
                                     kq_prefill_paged_attention_ref)
from repro_torch.kernels import build
from repro_torch.kernels.kq_decode import (kq_decode_paged_attention,
                                           kq_prefill_paged_attention)
from repro_torch.kernels.kq_decode.kq_decode import MAX_GROUP, MAX_RANK

# the reference kernel tests' tolerances (tests/test_kernels.py:15-17)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pools(seed, B, Hkv, n_pages, ps, Rk, Rv):
    """Pools plus a scrambled block table: physical ids do not follow
    logical order, so parity holds only if the table is dereferenced."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pages
    kp = rng.normal(size=(P, Hkv, ps, Rk)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, ps, Rv)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P, dtype=np.int32))
    return rng, kp, vp, perm[: B * n_pages].reshape(B, n_pages)


def _both(arrays, dtype):
    """The same values as jnp and torch arrays, the float ones in
    ``dtype`` (both round float32 to bfloat16 to nearest even)."""
    jx = [jnp.asarray(a) if a.dtype == np.int32
          else jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.as_tensor(a) if a.dtype == np.int32
          else torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,n_pages,ps,Rk,Rv,lengths", [
    (2, 4, 2, 4, 16, 16, 16, (64, 7)),            # full + short
    (3, 4, 2, 5, 8, 16, 8, (40, 8, 9)),           # page-boundary edges
    (1, 8, 4, 3, 16, 8, 16, (17,)),               # crosses into page 2
    (2, 2, 2, 2, 32, 16, 16, (1, 33)),
])
def test_k1_plain_matches_reference(B, H, Hkv, n_pages, ps, Rk, Rv,
                                    lengths, dtype):
    rng, kp, vp, btab = _pools(0, B, Hkv, n_pages, ps, Rk, Rv)
    qc = rng.normal(size=(B, H, Rk)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    (jq, jk, jv, jl, jb), (tq, tk, tv, tl, tb) = _both(
        [qc, kp, vp, lens, btab], dtype)
    want = kq_decode_paged_attention_ref(jq, jk, jv, jl, jb, scale=0.25)
    got = kq_decode_paged_attention(tq, tk, tv, tl, tb, scale=0.25)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, H, Rv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("pos0", [(0, 0), (3, 8), (5, 13)],
                         ids=["start", "page-aligned", "mid-page"])
def test_k2_plain_matches_reference(pos0):
    """A chunk of 8 queries, the second row with 3 bucket-padding queries
    (which see the whole prefix, as in the kernel)."""
    B, Hkv, m, ps, n_pages, Rk, Rv, S = 2, 2, 2, 8, 4, 16, 12, 8
    rng, kp, vp, btab = _pools(1, B, Hkv, n_pages, ps, Rk, Rv)
    qc = rng.normal(size=(B, Hkv * m, S, Rk)).astype(np.float32)
    pos0 = np.asarray(pos0, np.int32)
    lengths = pos0 + np.asarray([S, S - 3], np.int32)
    (jq, jk, jv, jl, jp, jb), (tq, tk, tv, tl, tp, tb) = _both(
        [qc, kp, vp, lengths, pos0, btab], "float32")
    want = kq_prefill_paged_attention_ref(jq, jk, jv, jl, jp, jb, scale=0.3)
    got = kq_prefill_paged_attention(tq, tk, tv, tl, tp, tb, scale=0.3)
    assert tuple(got.shape) == (B, Hkv * m, S, Rv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_k1_plain_matches_pallas_interpret():
    rng, kp, vp, btab = _pools(2, 2, 2, 3, 8, 16, 8)
    qc = rng.normal(size=(2, 4, 16)).astype(np.float32)
    lens = np.asarray([17, 5], np.int32)
    (jq, jk, jv, jl, jb), (tq, tk, tv, tl, tb) = _both(
        [qc, kp, vp, lens, btab], "float32")
    want = kq_decode_paged_attention_op(jq, jk, jv, jl, jb, scale=0.25,
                                        interpret=True)
    got = kq_decode_paged_attention(tq, tk, tv, tl, tb, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_k2_plain_matches_pallas_interpret():
    """Mid-page start, one padded row: the padding queries too agree."""
    B, Hkv, m, ps, n_pages, R, S = 2, 2, 2, 4, 4, 8, 4
    rng, kp, vp, btab = _pools(3, B, Hkv, n_pages, ps, R, R)
    qc = rng.normal(size=(B, Hkv * m, S, R)).astype(np.float32)
    pos0 = np.asarray([5, 2], np.int32)
    lengths = pos0 + np.asarray([S, 1], np.int32)
    (jq, jk, jv, jl, jp, jb), (tq, tk, tv, tl, tp, tb) = _both(
        [qc, kp, vp, lengths, pos0, btab], "float32")
    want = kq_prefill_paged_attention_op(jq, jk, jv, jl, jp, jb, scale=0.5,
                                         interpret=True,
                                         max_len=n_pages * ps)
    got = kq_prefill_paged_attention(tq, tk, tv, tl, tp, tb, scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_zero_length_gives_zero_like_the_kernels():
    rng, kp, vp, btab = _pools(4, 2, 1, 2, 4, 8, 8)
    lens = torch.tensor([0, 5], dtype=torch.int32)
    k, v, bt = (torch.as_tensor(a) for a in (kp, vp, btab))
    q1 = torch.as_tensor(rng.normal(size=(2, 2, 8)).astype(np.float32))
    out1 = kq_decode_paged_attention(q1, k, v, lens, bt)
    q2 = torch.as_tensor(rng.normal(size=(2, 2, 3, 8)).astype(np.float32))
    out2 = kq_prefill_paged_attention(q2, k, v, lens,
                                      torch.zeros(2, dtype=torch.int32), bt)
    assert (out1[0] == 0).all() and (out2[0] == 0).all()
    assert (out1[1] != 0).any() and (out2[1] != 0).any()


def test_dead_rows_do_not_leak_nan():
    """Entries at or past a slot's length may hold anything (NaN too)."""
    rng, kp, vp, btab = _pools(5, 1, 1, 3, 4, 4, 4)
    k, v, bt = (torch.as_tensor(a) for a in (kp, vp, btab))
    q = torch.as_tensor(rng.normal(size=(1, 2, 4)).astype(np.float32))
    q2 = q[:, :, None].expand(1, 2, 2, 4).contiguous()
    lens = torch.tensor([6], dtype=torch.int32)
    pos0 = torch.tensor([4], dtype=torch.int32)
    clean = (kq_decode_paged_attention(q, k, v, lens, bt),
             kq_prefill_paged_attention(q2, k, v, lens, pos0, bt))
    for pool in (k, v):
        pool[bt[0, 1], :, 2:] = float("nan")      # tokens 6, 7
        pool[bt[0, 2]] = float("nan")             # tokens 8..11
    dirty = (kq_decode_paged_attention(q, k, v, lens, bt),
             kq_prefill_paged_attention(q2, k, v, lens, pos0, bt))
    for a, b in zip(clean, dirty):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions: nothing is
    built or launched.  Another device raises."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU call")

    monkeypatch.setattr(build, "load", no_build)
    rng, kp, vp, btab = _pools(6, 2, 2, 2, 4, 8, 8)
    k, v, bt = (torch.as_tensor(a) for a in (kp, vp, btab))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    q1 = torch.as_tensor(rng.normal(size=(2, 4, 8)).astype(np.float32))
    q2 = torch.as_tensor(rng.normal(size=(2, 4, 2, 8)).astype(np.float32))
    before = (kq_decode_paged_attention.launches,
              kq_prefill_paged_attention.launches)
    kq_decode_paged_attention(q1, k, v, lens, bt)
    kq_prefill_paged_attention(q2, k, v, lens, lens - 2, bt)
    assert (kq_decode_paged_attention.launches,
            kq_prefill_paged_attention.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        kq_decode_paged_attention(q1.to("meta"), k, v, lens, bt)
    with pytest.raises(ValueError, match="unsupported device"):
        kq_prefill_paged_attention(q2.to("meta"), k, v, lens, lens, bt)


def test_module_imports_without_nvcc(tmp_path):
    """Importing the K1/K2 module and running it on CPU tensors needs no
    compiler: the build is lazy (here with an empty PATH)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels.kq_decode import paged\n"
        "q = torch.randn(1, 2, 4); k = torch.randn(3, 1, 4, 4)\n"
        "bt = torch.tensor([[2, 1]], dtype=torch.int32)\n"
        "n = torch.tensor([6], dtype=torch.int32)\n"
        "out = paged.kq_decode_paged_attention(q, k, k, n, bt)\n"
        "out2 = paged.kq_prefill_paged_attention(q[:, :, None], k, k, n,\n"
        "                                        n - 1, bt)\n"
        "assert out.shape == (1, 2, 4) and out2.shape == (1, 2, 1, 4)\n"
        "assert not build._loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """The library's name hashes its source and the headers it includes,
    so an edited shared header never loads a stale library: the shared
    bodies (float32 and bf16 decode) reach K3's and the paged library,
    bf16 K2's body the paged one alone."""
    names = ("kq_decode", "kq_paged")
    assert sorted(p.name for p in build.sources("kq_decode")) == \
        ["kq_attend.cuh", "kq_decode.cu", "kq_decode_tc.cuh"]
    assert sorted(p.name for p in build.sources("kq_paged")) == \
        ["kq_attend.cuh", "kq_decode_tc.cuh", "kq_paged.cu",
         "kq_prefill.cuh"]
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in names}
    with open(tmp_path / "kq_prefill.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("kq_decode") == before["kq_decode"]
    assert build.library_path("kq_paged") != before["kq_paged"]
    for header in ("kq_attend.cuh", "kq_decode_tc.cuh"):
        before = {n: build.library_path(n) for n in names}
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        for name, path in before.items():
            assert build.library_path(name) != path


def test_bf16_k2_widths_cover_every_rank_the_wrapper_takes():
    """bf16 K2's p.v widths (``KQ_PREFILL_PV_WIDTHS`` in
    ``csrc/kq_prefill.cuh``, read as text) are multiples of 8 up to
    ``wgmma``'s 256 whose largest is ``MAX_RANK``, so the wrapper refuses
    no Rv in 1..MAX_RANK; the body's rank and group limits are the
    wrapper's."""
    src = (build.CSRC / "kq_prefill.cuh").read_text()
    body = re.search(r"#define KQ_PREFILL_PV_WIDTHS\(X\)((?:[^\n]*\\\n)*"
                     r"[^\n]*)", src).group(1)
    widths = [int(w) for w in re.findall(r"X\((\d+)\)", body)]
    assert widths == sorted(set(widths))
    assert all(w % 8 == 0 and 8 <= w <= 256 for w in widths)
    assert widths[-1] == MAX_RANK
    assert re.search(r"constexpr int kMaxR = (\d+);", src).group(1) == \
        str(MAX_RANK)
    assert f"H / Hkv > {MAX_GROUP}" in src


def test_ctypes_signatures_match_the_c_entry_points():
    """The argument types the wrapper declares for each C entry point of
    ``csrc/kq_paged.cu`` are its parameters in order (a pointer cut to a
    32-bit int, or one argument too few, would fault only on the card)."""
    import ctypes

    from repro_torch.kernels.kq_decode import paged
    src = (build.CSRC / "kq_paged.cu").read_text()
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for name, want in paged._SIGNATURES.items():
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1)
        got = [kinds[re.sub(r"\s+", "", re.sub(r"\bconst\b", "",
                                               p.rsplit(None, 1)[0]))]
               for p in params.split(",")]
        assert got == want, name


def test_arrival_counter_stride_matches_the_kernel():
    """The wrapper sizes bf16 split decode's arrival counters by the
    stride the kernel indexes them with (``kCountStride``, read as text
    from ``csrc/kq_decode_tc.cuh``): a 128-byte line a (slot, kv group)."""
    from repro_torch.kernels.kq_decode import paged
    src = (build.CSRC / "kq_decode_tc.cuh").read_text()
    stride = int(re.search(r"constexpr int kCountStride = (\d+);",
                           src).group(1))
    assert paged.ARRIVAL_STRIDE == stride and stride * 4 == 128
