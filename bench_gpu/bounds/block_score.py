"""Kernel C, the graph engine's neighbour-block score
(``csrc/block_score.cu`` ``block_score_kernel``, ``block_score_direct``):
each query against the F rows of each of its E candidates' blocks, 2 B E F
D operations (fp32 peak: the core converts f16 / bf16 rows to f32); each
block row and its sqnorm read once, the query, its sqnorm and the
candidate ids read once, the [B, E F] f32 scores written once."""

ENTRY = "redis_hnsw_tpu_torch.ops.cuda_gather:fused_block_score"
PEAK = "fp32"


def cost(q, qn, nbrvec, nbrsqn, cand, **_):
    B, E = cand.shape
    F = nbrvec.shape[1]
    D = q.shape[1]
    elem = nbrvec.element_size()
    return (2.0 * B * E * F * D,
            B * E * F * D * elem + B * E * F * 4 * 2 + B * D * 4 + B * 4
            + B * E * 4)
