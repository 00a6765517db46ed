"""Kernel A′, the exact hamming tier's select (``csrc/scan_topk.cu``
``hamming_tile_kernel``, then ``list_merge_kernel``): every query against
every row of W packed 32-bit words as ±1 int8 products on the tensor
cores, 2 B N 32 W operations; the query and row words and the row bias
read once, the k-entry lists written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_scan:flat_topk_hamming"
PEAK = "int8"


def cost(queries, words, bias, *, k, **_):
    B, W = queries.shape
    N = words.shape[0]
    return (2.0 * B * N * 32 * W,
            4.0 * (B * W + N * W + N) + 8.0 * B * k)
