"""Reference: modmap's indexed reference structure (reference: modmap.c:35-182).

A modset over the reference plus parallel arrays over *reference occurrences*
(stream order): ``index`` (modset id per occurrence), ``offset`` (position in
its sequence), ``id`` (sequence-name dict id), plus an inverted CSR map
``loc[mod] -> rev[...]`` listing occurrences of each mod.  Construction runs
the port's scanner over the whole reference stream on the given device; the
CSR inverse is a stable argsort (occurrence order within each mod, exactly
like referencePack's two-pass build at modmap.c:74-91).  The ``.ref`` bytes
are the JAX package's (``modimizer_tpu/core/reference.py``).
"""

import numpy as np

from ..io import seqio
from ..io.carray import CArray, CDict
from ..io.fzio import GzWriter, read_maybe_gz
from ..ops.seqhash import ModimizerScanner
from ..utils import profiling
from .modset import Modset

MAGIC = b"RFMSHv1\x00"


class Reference:
    def __init__(self, ms: Modset, size: int):
        if not ms or not ms.size:
            raise ValueError("modset must be initialised before reference")
        if not size:
            raise ValueError("refCreate must have size > 0")
        self.ms = ms
        self.size = size
        self.max = 0
        self.device_table = None   # lazy sorted device table (-q seeding)
        self.index = np.zeros(0, np.uint32)
        self.offset = np.zeros(0, np.uint32)
        self.id = np.zeros(0, np.uint32)
        self.depth = np.zeros(0, np.uint32)
        self.rev = None
        self.loc = None
        self.dict = CDict(1024)
        self.len = CArray(1024, 4, np.uint32)

    # ------------- construction -------------

    def fasta_read(self, filename, out, is_add=True, device=None):
        """referenceFastaRead (modmap.c:93-134), batched on ``device`` (the
        scanner's: None takes the CUDA card unless MODIMIZER_SCAN=host)."""
        try:
            with profiling.stage("ref.parse"):
                batch, _t = seqio.read_seq_file(
                    filename, seqio.dna2index_n0(), is_qual=False,
                    want_ids=True)
        except (IOError, ValueError, FileNotFoundError):
            raise IOError(f"failed to read reference sequence file {filename}")
        for i, name in enumerate(batch.ids):
            _id, is_new = self.dict.add(name)
            if not is_new:
                raise ValueError(f"duplicate ref sequence name {name}")
            self.len.set(_id, np.uint32(batch.lengths[i]))
        tot_len = int(batch.lengths.sum())

        scanner = ModimizerScanner(self.ms.hasher, want_isf=False,
                                   device=device)
        with profiling.stage("ref.scan"):
            kmers, rid, rpos, _isF = scanner.scan_batch(batch)
        if is_add:
            # modmap inserts via modsetIndexFind only — ms->depth stays zero
            # (occurrence counts live in ref->depth; modmap.c:109-117)
            idx = self.ms.add_batch(kmers, np.zeros(len(kmers), np.uint32),
                                    return_indices=True)
        else:
            idx = self.ms.find_batch(kmers)
            keep = idx != 0
            idx, rid, rpos = idx[keep], rid[keep], rpos[keep]
        if len(idx) + 1 >= self.size:
            raise RuntimeError("reference size overflow")
        self.index = idx.astype(np.uint32)
        self.offset = rpos.astype(np.uint32)
        self.id = rid.astype(np.uint32)
        self.max = len(idx)
        self.depth = np.bincount(self.index,
                                 minlength=self.ms.max + 1).astype(np.uint32)

        out.write("  %d hashes from %d reference sequences, total length %d\n"
                  % (self.max, self.dict.max, tot_len))
        # copy numbers from reference occurrence counts (modmap.c:125-130)
        d = self.depth[1:self.ms.max + 1]
        info = self.ms.info[1:self.ms.max + 1]
        c1 = d == 1
        c2 = d == 2
        cM = ~c1 & ~c2
        info[c1] = (info[c1] & 0xFC) | 1
        info[c2] = (info[c2] & 0xFC) | 2
        info[cM] |= 3
        out.write("  %d copy 1, %d copy 2, %d multiple\n"
                  % (c1.sum(), c2.sum(), cM.sum()))
        if is_add:
            self.ms.pack()
        self.pack()

    def pack(self):
        """referencePack (modmap.c:74-91): CSR inverse via stable sort."""
        self.size = self.max
        nm = self.ms.max
        self.loc = np.zeros(nm + 1, np.uint32)
        self.loc[1:] = np.cumsum(self.depth[:nm], dtype=np.int64)[:nm]
        self.rev = np.argsort(self.index, kind="stable").astype(np.uint32)
        # argsort groups occurrences by mod id ascending, stream order within
        # — identical to the reference's counting pass

    # ------------- persistence -------------

    def write(self, root):
        self.ms.write(root + ".mod")
        with GzWriter(root + ".ref") as f:
            f.write(MAGIC)
            f.write(int(self.max).to_bytes(4, "little"))
            f.write(int(self.max).to_bytes(4, "little"))
            f.write(self.index[:self.max])
            f.write(self.offset[:self.max])
            f.write(self.id[:self.max])
            f.write(self.depth[:self.ms.max + 1])
            f.write(self.rev[:self.max])
            f.write(self.loc[:self.ms.max + 1])
            self.len.write(f)
            self.dict.write(f)

    @classmethod
    def read(cls, root):
        ms = Modset.read(root + ".mod")
        import io
        with io.BytesIO(read_maybe_gz(root + ".ref")) as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError("bad reference header")
            size = int.from_bytes(f.read(4), "little")
            ref = cls(ms, size if size else 1)
            ref.max = int.from_bytes(f.read(4), "little")
            ref.index = np.frombuffer(f.read(4 * size), np.uint32).copy()
            ref.offset = np.frombuffer(f.read(4 * size), np.uint32).copy()
            ref.id = np.frombuffer(f.read(4 * size), np.uint32).copy()
            ref.depth = np.frombuffer(f.read(4 * (ms.max + 1)),
                                      np.uint32).copy()
            ref.rev = np.frombuffer(f.read(4 * size), np.uint32).copy()
            ref.loc = np.frombuffer(f.read(4 * (ms.max + 1)),
                                    np.uint32).copy()
            ref.len = CArray.read(f, np.uint32)
            ref.dict = CDict.read(f)
        return ref
