"""Kernel A-int8, the int8 tier's select (``csrc/scan_int8.cu``
``int8_tile_kernel``, or the general form ``lowp_tile_kernel``, then
``list_merge_kernel``): 2 B N D int8 operations on the tensor cores; the
int8 queries and rows, their f32 scales and sqnorms read once, the
k-entry lists written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_scan:flat_topk_int8"
PEAK = "int8"


def cost(q8, qscale, t8, tscale, sq_masked, qq, *, k, **_):
    B, D = q8.shape
    N = t8.shape[0]
    return (2.0 * B * N * D,
            1.0 * (B + N) * D + 8.0 * (N + B) + 8.0 * B * k)
