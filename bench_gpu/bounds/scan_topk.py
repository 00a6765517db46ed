"""Kernel A, the exact tier's select (``csrc/scan_topk.cu``
``scan_tile_kernel``, then ``list_merge_kernel`` over the splits): every
query scored against every row in fp32 matmul form on the CUDA cores,
2 B N D operations; the queries, the rows and both sqnorms read once,
the k-entry (score, id) lists written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_scan:flat_topk"
PEAK = "fp32"


def cost(queries, vecs, sq_masked, qq, *, k, **_):
    B, D = queries.shape
    N = vecs.shape[0]
    return 2.0 * B * N * D, 4.0 * (B * D + N * D + N + B) + 8.0 * B * k
