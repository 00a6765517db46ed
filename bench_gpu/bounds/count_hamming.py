"""Kernel B′, the certified hamming tier's count (``csrc/count_hamming.cu``
``count_hamming_kernel``): mma.sync m16n8k256 b1 products over the
packed words, each counted as the m16n8k32 int8 product it runs at the
rate of (16 * 8 * 32 * 2 operations); the words, bias and thresholds read
once, two counts a query written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_count_hamming:count_hamming"
PEAK = "int8"


def cost(queries, words, bias, t, **_):
    B, W = queries.shape
    N = words.shape[0]
    products = -(-B // 16) * -(-N // 8) * -(-W // 8)
    return (products * 16.0 * 8 * 32 * 2,
            4.0 * (B * W + N * W + N + B) + 8.0 * B)
