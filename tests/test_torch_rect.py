"""The port's rectangular binned layout (gnnpe_tpu_torch/ops/rect.py)
against gnnpe_tpu/ops/rect.py and the dense sum, on numpy-seeded arc
lists; and the rectangular entry of kernel A1 (ops/spmm.py).

Host tables are numpy on both sides: bit-equal (tolerance 0).  The
device apply is f32 against the f64 dense sum: rtol 1e-4 / atol 1e-4, as
gnnpe_tpu's own tests of the layout.  The launch plan's walk against the
table-by-table sum, and the kernels against their plain versions on the
card, are bit-equal.

On the card (gnnpe_tpu and JAX are imported inside the CPU tests only):
    python -m pytest --noconftest -q -m cuda tests/test_torch_rect.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnnpe_tpu_torch.ops import ell, rect, spmm
from gnnpe_tpu_torch.ops.spmm import neighbor_sum_np


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random_csr(rng, v, e):
    """tests/test_parallel.py's arc lists."""
    src = rng.randint(0, v, e).astype(np.int32)
    dst = rng.randint(0, v, e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=v)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return offsets, src[order]


def _zipf_arcs():
    """tests/test_ops.py::test_rect_binned_hub_forced's arcs: few sources
    repeated heavily, so hubs are selected."""
    rng = np.random.RandomState(3)
    nd, ns, na = 200, 64, 5000
    dst = np.sort(rng.randint(0, nd, na))
    src = (rng.zipf(1.3, na) % ns).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=nd))])
    return offs, src, ns


def _head_arcs():
    """Rows past the widest class (a head chain of three levels), rows of
    every class and a zero tail, into 500 source rows."""
    rng = np.random.RandomState(0)
    deg = rng.randint(0, 6, 300)
    deg[:6] = [5000, 700, 150, 90, 70, 0]
    offs = np.concatenate([[0], np.cumsum(deg)])
    return offs, rng.randint(0, 500, offs[-1]).astype(np.int32), 500


ARCS = {
    "random": lambda: _random_csr(np.random.RandomState(7), 300, 2500)
    + (300,),
    "zipf_hubs": _zipf_arcs,
    "head_chain": _head_arcs,
    "no_arcs": lambda: (np.zeros(41, np.int64), np.zeros(0, np.int32), 17),
}


def _same_layout(ref, port):
    """Every field of gnnpe_tpu's dataclass, bit-equal in the port's."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, list):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert (x is None) == (y is None), f.name
                if x is not None:
                    assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", list(ARCS))
@pytest.mark.parametrize("hub", [True, False])
def test_host_tables_bit_equal(name, hub):
    from gnnpe_tpu.ops import rect as ref
    offs, src, ns = ARCS[name]()
    kw = dict(hub_matmul=hub)
    if name == "zipf_hubs":
        kw["hub_precision"] = "f32"
    a = ref.build_binned_rect(offs, src, ns, **kw)
    b = rect.build_binned_rect(offs, src, ns, **kw)
    _same_layout(a, b)
    if name == "zipf_hubs" and hub:
        assert b.hub_rows is not None and b.num_hub_arcs > 0
    if name == "head_chain":
        assert len(b.head_tables) >= 3 and b.num_zero > 0


def test_pad_spec_and_pad_rect_bit_equal():
    """Four shards' layouts (one with a head, one with no arcs at all)
    padded to their joint spec, as gnnpe_tpu's ``_stack`` does."""
    from gnnpe_tpu.ops import rect as ref
    arcs = [ARCS[k]() for k in ("random", "head_chain", "no_arcs",
                                "zipf_hubs")]
    lays = {m: [m.build_binned_rect(o, s, n) for o, s, n in arcs]
            for m in (ref, rect)}
    spec_a, spec_b = ref.rect_pad_spec(lays[ref]), rect.rect_pad_spec(
        lays[rect])
    assert dataclasses.astuple(spec_a) == dataclasses.astuple(spec_b)
    assert spec_a.num_out == spec_b.num_out
    for la, lb in zip(lays[ref], lays[rect]):
        (pa, ma), (pb, mb) = ref.pad_rect(la, spec_a), rect.pad_rect(
            lb, spec_b)
        _same_layout(pa, pb)
        assert np.array_equal(ma, mb)


@pytest.mark.parametrize("name", ["random", "zipf_hubs", "head_chain",
                                  "no_arcs"])
@pytest.mark.parametrize("hub", [True, False])
def test_apply_matches_dense_and_jax(name, hub):
    """``RectBinned.apply`` + ``unrank`` equal ``neighbor_sum_np`` (rtol
    1e-4 / atol 1e-4) and gnnpe_tpu's apply on the same tables (the same
    f32 sums in another order, rows of up to 5000 terms: rtol 1e-4 / atol
    1e-4 without hubs, 2e-3 relative with the bf16 hi/lo hub product)."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops import rect as ref
    offs, src, ns = ARCS[name]()
    x = np.random.RandomState(1).rand(ns, 16).astype(np.float32)
    lay = rect.build_binned_rect(offs, src, ns, hub_matmul=hub)
    dev = lay.on("cpu")
    out = dev.unrank(dev.apply(torch.from_numpy(x))).numpy()
    want = neighbor_sum_np(offs, src, x.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    jlay = ref.build_binned_rect(offs, src, ns, hub_matmul=hub)
    jout = np.asarray(jlay.apply(jnp.asarray(x)))[jlay.rank]
    tol = (dict(rtol=2e-3, atol=1e-4) if dev.hub_rows is not None
           else dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(out, jout, **tol)


@pytest.mark.parametrize("name", ["random", "zipf_hubs", "head_chain",
                                  "no_arcs"])
def test_plan_walk_equals_table_by_table(name):
    """The launch plan walked over ``gather_sum_plain`` is, bit for bit,
    gnnpe_tpu's ``apply``: each table summed on its own, the parts
    concatenated, the zero tail appended."""
    offs, src, ns = ARCS[name]()
    lay = rect.build_binned_rect(offs, src, ns, hub_matmul=False)
    dev = lay.on("cpu")
    x = torch.from_numpy(np.random.RandomState(2).rand(ns, 5).astype(
        np.float32))
    t = lambda a: None if a is None else torch.from_numpy(a)
    parts = []
    if lay.head_tables:
        cur = x
        for tbl, pc in zip(lay.head_tables, lay.head_padcnt):
            cur = ell.gather_sum_plain(cur, t(tbl), t(pc))
        parts.append(cur)
    for tbl, pc in zip(lay.class_tables, lay.class_padcnt):
        parts.append(ell.gather_sum_plain(x, t(tbl), t(pc)))
    parts.append(torch.zeros((lay.num_zero, 5)))
    assert torch.equal(dev.apply(x), torch.cat(parts))
    assert dev.launches_per_apply == max(len(lay.head_tables),
                                         int(lay.num_arcs > 0))


@pytest.mark.parametrize("name", ["random", "zipf_hubs", "head_chain"])
@pytest.mark.parametrize("hub", [True, False])
def test_transposed_backward_matches_autograd(name, hub):
    """``rect_aggregate``'s backward (the transposed layout's apply)
    against autograd through the plain scatter form of the same sum:
    rtol 1e-4 / atol 1e-4 without hubs, 2e-3 relative with them."""
    offs, src, ns = ARCS[name]()
    nd = len(offs) - 1
    fwd, bwd = rect.build_rect_pair(offs, src, ns, hub_matmul=hub)
    assert bwd.num_dst == ns and bwd.num_src_rows == fwd.num_out
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(ns, 8).astype(np.float32))
    w = torch.from_numpy(rng.rand(nd, 8).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    f, b = fwd.on("cpu"), bwd.on("cpu")
    (f.unrank(rect.rect_aggregate(f, b)(xa)) * w).sum().backward()
    xb = x.clone().requires_grad_(True)
    dst = torch.from_numpy(np.repeat(np.arange(nd), np.diff(offs)))
    plain = torch.zeros(nd, 8).index_add(0, dst,
                                         xb[torch.from_numpy(src).long()])
    (plain * w).sum().backward()
    tol = dict(rtol=2e-3, atol=1e-3) if hub else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **tol)


def test_upload_rejects_bad_layouts():
    offs, src, ns = ARCS["random"]()
    lay = rect.build_binned_rect(offs, src, ns)
    with pytest.raises(ValueError, match="num_src_rows"):
        dataclasses.replace(lay, num_src_rows=None).on("cpu")
    with pytest.raises(ValueError, match="outside"):
        dataclasses.replace(lay, num_src_rows=10).on("cpu")
    with pytest.raises(ValueError, match="cover"):
        dataclasses.replace(lay, num_zero=lay.num_zero + 1).on("cpu")
    with pytest.raises(ValueError, match="float32"):
        lay.on("cpu").apply(torch.zeros(ns + 1, 4))


# ---- kernel A1's rectangular entry -----------------------------------------

def _rect_csr(device="cpu"):
    offs, src, ns = ARCS["head_chain"]()
    return (torch.from_numpy(offs.astype(np.int32)).to(device),
            torch.from_numpy(src).to(device), offs, src, ns)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rectangular_neighbor_sum_plain(dtype):
    off, nbr, offs, src, ns = _rect_csr()
    x = np.random.RandomState(5).rand(ns, 3).astype(dtype)
    got = spmm.neighbor_sum(off, nbr, torch.from_numpy(x), rectangular=True)
    assert got.shape == (len(offs) - 1, 3)
    want = neighbor_sum_np(offs, src, x.astype(np.float64))
    if dtype == np.float64:
        assert np.array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        spmm.neighbor_sum(off, nbr, torch.from_numpy(x))      # not square
    with pytest.raises(ValueError):
        spmm.neighbor_sum(off, nbr, torch.from_numpy(x), with_vde=True,
                          rectangular=True)


def test_csr_sum_backward_is_the_transposed_sum():
    off, nbr, offs, src, ns = _rect_csr()
    nd = len(offs) - 1
    dst = np.repeat(np.arange(nd), np.diff(offs))
    pair = spmm.CsrPair.from_arcs(dst, src, nd, ns, "cpu")
    assert torch.equal(pair.offsets, off) and torch.equal(pair.neighbors, nbr)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(ns, 4)).requires_grad_(True)
    w = torch.from_numpy(rng.rand(nd, 4))
    (spmm.CsrSum.apply(x, pair) * w).sum().backward()
    want = np.zeros((ns, 4))
    np.add.at(want, src, w.numpy()[dst])
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-12, atol=1e-12)


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 8, 128, 130])
def test_rectangular_kernel_matches_plain_on_cuda(cuda_device, dtype, d):
    """A1 with source rows ≠ output rows, bit-equal to the plain version:
    more source rows than output rows and fewer, rows of degree 0 at the
    tail, no arcs at all, and an x whose first byte is only
    element-aligned."""
    rng = np.random.RandomState(8)
    for name in ("head_chain", "random", "zipf_hubs", "no_arcs"):
        offs, src, ns = ARCS[name]()
        off = torch.from_numpy(offs.astype(np.int32)).to(cuda_device)
        nbr = torch.from_numpy(src).to(cuda_device)
        x = torch.from_numpy(rng.rand(ns, d).astype(dtype)).to(cuda_device)
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        shifted = flat[1:].view(x.shape).copy_(x)
        plain = spmm.neighbor_sum_plain(off, nbr, x)
        for xin in (x, shifted):
            before = spmm.LAUNCHES
            got = spmm.neighbor_sum(off, nbr, xin, rectangular=True)
            torch.cuda.synchronize()
            assert spmm.LAUNCHES == before + 1
            assert got.shape == plain.shape and torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 5, 8, 128, 130])
def test_rect_plan_matches_plain_on_cuda(cuda_device, d):
    """``RectBinnedDevice.apply`` on kernel A2, bit-equal to the plan
    walked over ``gather_sum_plain``: a layout with a three-level head
    and a zero tail, one with hubs, one with no head, one with no arcs
    (a shard with no halo arcs), each with its transposed layout, on an
    unaligned x; and the backward equal to the transposed apply."""
    rng = np.random.RandomState(9)
    for name in ("head_chain", "zipf_hubs", "random", "no_arcs"):
        offs, src, ns = ARCS[name]()
        for lay in rect.build_rect_pair(offs, src, ns):
            dev = lay.on(cuda_device)
            n_src = lay.num_src_rows
            x = torch.from_numpy(rng.rand(n_src, d).astype(np.float32)
                                 ).to(cuda_device)
            flat = torch.empty(x.numel() + 1, dtype=x.dtype,
                               device=cuda_device)
            shifted = flat[1:].view(x.shape).copy_(x)
            want = dev.apply(x, gather=ell.gather_sum_plain)
            for xin in (x, shifted):
                before = ell.LAUNCHES
                got = dev.apply(xin)
                torch.cuda.synchronize()
                assert ell.LAUNCHES == before + dev.launches_per_apply
                assert torch.equal(got, want)
        fwd, bwd = (l.on(cuda_device)
                    for l in rect.build_rect_pair(offs, src, ns))
        xg = torch.from_numpy(rng.rand(ns, d).astype(np.float32)).to(
            cuda_device).requires_grad_(True)
        cot = torch.rand((fwd.num_out, d), device=cuda_device)
        rect.rect_aggregate(fwd, bwd)(xg).backward(cot)
        assert torch.equal(xg.grad, bwd.unrank(bwd.apply(cot)))
