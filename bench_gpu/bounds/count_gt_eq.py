"""Kernel B, the two-pass certificate's count (``csrc/count_gt_eq.cu``
``count_kernel``): every query against every row in fp32 matmul form,
2 B N D operations; the queries, rows, sqnorms and thresholds read once,
two int32 counts a query written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_count:count_gt_eq"
PEAK = "fp32"


def cost(vecs, sq_masked, q, qq, t, **_):
    B, D = q.shape
    N = vecs.shape[0]
    return 2.0 * B * N * D, 4.0 * (B * D + N * D + N + B) + 4.0 * B + 8.0 * B
