"""ops/knn's dispatch between csrc/nearest_vertex.cu and the plain chunked
path, on the CPU: which inputs reach the kernel, what its wrapper refuses
before anything touches a card, and the kernel's block and stage
sizes. The kernel itself runs only on the card
(tests/test_torch_cuda.py, ``-k knn``)."""

import numpy as np
import pytest
import torch

from avatarcap_tpu_torch.ops import knn as K


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so that knn's
    dispatch can be driven without a card."""

    @property
    def is_cuda(self):
        return True


def _cuda_like(t):
    return torch.Tensor._make_subclass(_CudaLike, t)


def _inputs(n=300, m=200, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return (torch.as_tensor(rs.uniform(-1, 1, (n, 3)).astype(dtype)),
            torch.as_tensor(rs.uniform(-1, 1, (m, 3)).astype(dtype)))


@pytest.mark.parametrize("k", [1, 4])
def test_knn_on_cpu_takes_the_plain_path(k):
    """A CPU call returns knn_plain's bits, launches nothing and opens no
    ``knn_kernel`` span under a tracer (only ``knn``)."""
    from avatarcap_tpu_torch.utils.timers import Tracer
    q, v = _inputs(seed=k)
    before = K.nearest_vertex.launches
    tracer = Tracer("cpu")
    with tracer("stage"):
        d, i = K.knn(q, v, k=k, chunk=64)
    assert K.nearest_vertex.launches == before
    assert [s.name for s in tracer.collect()] == ["stage", "knn"]
    d_ref, i_ref = K.knn_plain(q, v, k, 64)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    assert d.shape == i.shape == (300, k) and i.dtype == torch.int64


@pytest.mark.parametrize("case", ["k1_float32", "k2_float32", "k4_float32",
                                  "k1_float64", "k1_float32_float64_db"])
def test_knn_dispatch_reads_device_k_and_dtype(monkeypatch, case):
    """On a CUDA tensor, k = 1 with float32 queries and database goes to
    nearest_vertex (the chunk has no effect there); k > 1 or float64 keep
    the plain chunked path."""
    calls = []

    def kernel(queries, database):
        calls.append((queries.shape, database.shape))
        return K.knn_plain(queries, database, 1, 10 ** 6)
    monkeypatch.setattr(K, "nearest_vertex", kernel)
    k = int(case[1])
    q, v = _inputs(seed=3, dtype=np.float64 if case == "k1_float64"
                   else np.float32)
    if case.endswith("_db"):
        v = v.double()
    if case == "k1_float32_float64_db":
        with pytest.raises(RuntimeError):      # the plain path's matmul
            K.knn(_cuda_like(q), _cuda_like(v), k=k, chunk=32)
        assert calls == []
        return
    d, i = K.knn(_cuda_like(q), _cuda_like(v), k=k, chunk=32)
    assert calls == ([((300, 3), (200, 3))] if case == "k1_float32" else [])
    d_ref, i_ref = K.knn_plain(q, v, k, 32)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("case", ["cpu", "float64_queries", "float16_db",
                                  "two_columns", "flat", "noncontiguous",
                                  "noncontiguous_db"])
def test_nearest_vertex_rejects_what_the_kernel_does_not_take(case):
    """The wrapper's checks, which run before anything touches a card."""
    q, v = _inputs(n=40, m=30)
    match = {"cpu": "CUDA", "float64_queries": "float32",
             "float16_db": "float32", "two_columns": r"\(rows, 3\)",
             "flat": r"\(rows, 3\)", "noncontiguous": "contiguous",
             "noncontiguous_db": "contiguous"}[case]
    if case == "float64_queries":
        q = q.double()
    elif case == "float16_db":
        v = v.half()
    elif case == "two_columns":
        q = q[:, :2].contiguous()
    elif case == "flat":
        v = v.reshape(-1)
    elif case == "noncontiguous":
        q = torch.cat([q, q], 1)[:, ::2]
        assert q.shape == (40, 3) and not q.is_contiguous()
    elif case == "noncontiguous_db":
        v = v.t().contiguous().t()
    before = K.nearest_vertex.launches
    with pytest.raises(ValueError, match=match):
        K.nearest_vertex(q, v)
    assert K.nearest_vertex.launches == before


def test_nearest_vertex_constants_match_the_source():
    """csrc/nearest_vertex.cu's block, stage and combine sizes: the body
    (the toy body's 6,842 vertices, SMPL's 6,890) is one stage, and two
    blocks of a whole stage fit an H100 SM's 228 KB of shared memory (1 KB
    of each block's is the system's)."""
    from avatarcap_tpu_torch import kernels
    c = kernels.source_constants("nearest_vertex.cu")
    assert c["kWarps"] * 32 == c["kBlockThreads"]
    assert c["kBlockQueries"] == 32 * c["kQueriesPerLane"]
    assert c["kCombineBytes"] == 8 * c["kBlockQueries"] * c["kWarps"]
    assert c["kCombineBytes"] <= 16 * c["kStageVertices"]
    assert c["kStageVertices"] >= 6890
    assert 2 * (16 * c["kStageVertices"] + 1024) <= 228 * 1024
    assert "nearest_vertex" in kernels.SOURCES
