"""Kernel D, the one-pass certified tier's select
(``csrc/select_bins.cu`` ``select_bins_kernel``, then ``m2_reduce_kernel``):
every query against every row in fp32 matmul form, 2 B N D operations;
the queries, rows and sqnorms read once, a (score, row) pair per
128-row bin and the m2 bound a query written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_select:select_bins"
PEAK = "fp32"
BIN_ROWS = 128  # rows a bin (ops/cuda_select.py BIN_L)


def cost(vecs, sq_masked, q, qq, **_):
    B, D = q.shape
    N = vecs.shape[0]
    nbins = -(-N // BIN_ROWS)
    return (2.0 * B * N * D,
            4.0 * (B * D + N * D + N + B) + 8.0 * B * nbins + 4.0 * B)
