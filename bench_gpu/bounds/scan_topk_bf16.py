"""Kernel A-bf16, the bf16 tier's select (``csrc/scan_bf16.cu``
``bf16_tile_kernel``, or the general form ``lowp_tile_kernel``, then
``list_merge_kernel``): 2 B N D bf16 operations on the tensor cores; the
bf16 queries and rows, the f32 sqnorms read once, the k-entry lists
written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_scan:flat_topk_bf16"
PEAK = "bf16"


def cost(q16, t16, sq_masked, qq, *, k, **_):
    B, D = q16.shape
    N = t16.shape[0]
    return (2.0 * B * N * D,
            2.0 * (B + N) * D + 4.0 * (N + B) + 8.0 * B * k)
