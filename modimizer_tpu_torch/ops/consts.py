"""Chunk and compaction-block sizes shared by the kernel wrappers, the
scanner and the builder (the JAX package keeps them in ``ops/seqhash.py``;
here they sit below every module that uses them)."""

import math
import os

BLOCK = 4096             # the chunk is a multiple of this many positions
# scan_compact's compaction block is one CUDA thread block of at most 1,024
# threads, 32 positions a thread
MAX_BLK = 1 << 15
# positions per compaction block of scan_compact (MODIMIZER_BLK, as in the
# JAX package, so both packages block alike)
BLK_COMPACT = int(os.environ.get("MODIMIZER_BLK", "512"))
if BLK_COMPACT < 128 or (BLK_COMPACT & (BLK_COMPACT - 1)):
    raise ValueError("MODIMIZER_BLK must be a power of two >= 128")
if BLK_COMPACT > MAX_BLK:
    raise ValueError(
        "MODIMIZER_BLK=%d: scan_compact takes at most %d positions a "
        "compaction block (one 1,024-thread block of 32 positions a thread)"
        % (BLK_COMPACT, MAX_BLK))


def scan_bo(w: int, blk: int = BLK_COMPACT) -> int:
    """Output rows per blk-position compaction block: mean + 6 sigma of the
    Binomial(blk, 1/w) emit count (overflow is flagged and the caller
    rescans)."""
    forced = os.environ.get("MODIMIZER_BO")
    if forced:                     # ablation override (8-row granules)
        return int(min(blk, max(8, (int(forced) + 7) // 8 * 8)))
    mean = max(1, blk // w)
    # ceil the sigma so the margin stays >= 6 sigma at small blk
    want = mean + 6 * max(1, math.isqrt(mean - 1) + 1)
    return int(min(blk, max(8, ((want + 7) // 8) * 8)))
