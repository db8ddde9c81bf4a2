"""Local de Bruijn assembly of candidate haplotypes.

The GATK HaplotypeCaller step the reference accelerates only *around*
(assembly stays on CPU even in the FPGA pipeline — the Blaze NAM serves
PairHMM only, SURVEY.md §2 row 25).  The same split holds here: assembly is
host-side, branchy graph code; its output feeds the PairHMM TPU kernel.

Algorithm (GATK-flavored, simplified):
* k-mer graph from the reads of an active region; the reference haplotype's
  k-mers are always included (so the ref path always exists);
* edges below a multiplicity threshold are pruned unless on the ref path;
* haplotypes = all source→sink paths (bounded DFS); cyclic graphs retry
  with a larger k, then fall back to the reference haplotype alone.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

MAX_PATHS = 128
MAX_HAPLOTYPES = 16


@dataclasses.dataclass
class AssemblyParams:
    # Ladder starts LOW like GATK's (10, 25): a k=25 path through a
    # variant needs a read spanning k−1 bases on BOTH sides, and reads
    # clipped to a ~110 bp active region often leave only one such
    # spanner — the variant bubble then prunes at min_edge_mult and the
    # region assembles ref-only (round-5 classification: ~2/3 of the 60 Mb
    # rehearsal's 210 missed sites, each with 4-10 alt reads, failed
    # exactly this way).  Cyclic/blowup regions escalate to larger k as
    # before, so repetitive contexts are unaffected.
    kmer_sizes: tuple[int, ...] = (15, 25, 35)
    min_edge_mult: int = 2      # prune threshold (GATK pruneFactor)
    max_haplotypes: int = MAX_HAPLOTYPES


@dataclasses.dataclass
class AssemblyResult:
    haplotypes: list[np.ndarray]     # uint8 code arrays; [0] is the ref
    kmer_size: int
    fallback: bool                   # True if assembly failed → ref only


def _build_graph(ref: np.ndarray, reads: list[np.ndarray], k: int,
                 min_mult: int):
    """(k-1)-mer node graph. Returns (edges: node -> {next_base: count},
    ref_edges set) or None if ref too short."""
    if len(ref) <= k:
        return None, None
    edges: dict[bytes, dict[int, int]] = defaultdict(lambda: defaultdict(int))
    ref_edges: set[tuple[bytes, int]] = set()

    def add_seq(codes: np.ndarray, is_ref: bool):
        b = bytes(codes)
        if len(b) < k:
            return
        for i in range(len(b) - k + 1):
            if 4 in b[i:i + k]:
                continue
            node = b[i:i + k - 1]
            nxt = b[i + k - 1]
            edges[node][nxt] += 1
            if is_ref:
                ref_edges.add((node, nxt))

    add_seq(ref, True)
    for r in reads:
        add_seq(r, False)

    # prune low-multiplicity non-ref edges
    pruned: dict[bytes, dict[int, int]] = {}
    for node, outs in edges.items():
        keep = {nb: c for nb, c in outs.items()
                if c >= min_mult or (node, nb) in ref_edges}
        if keep:
            pruned[node] = keep
    return pruned, ref_edges


def _enumerate_paths(graph, source: bytes, sink: bytes, k: int,
                     max_len: int) -> list[bytes] | None:
    """All source→sink node paths as sequences; None if cyclic blowup."""
    results: list[bytes] = []
    # iterative DFS with explicit stack: (node, seq_so_far, visited_len)
    stack = [(source, source)]
    steps = 0
    while stack:
        steps += 1
        if steps > 200000 or len(results) > MAX_PATHS:
            return None
        node, seq = stack.pop()
        if len(seq) > max_len:
            continue
        if node == sink and len(seq) > len(source):
            results.append(seq)
            # sink may have outgoing edges (repeat) — do not extend further
            continue
        for nb, _cnt in sorted(graph.get(node, {}).items()):
            nseq = seq + bytes([nb])
            stack.append((nseq[-(k - 1):], nseq))
    return results


def assemble_region(ref: np.ndarray, reads: list[np.ndarray],
                    params: AssemblyParams = AssemblyParams()
                    ) -> AssemblyResult:
    """Assemble candidate haplotypes for one active region.

    The returned haplotype list always starts with the reference haplotype;
    assembled haplotypes differing from it follow, deduplicated, capped at
    ``params.max_haplotypes``.

    Uses the native fgio implementation when built (identical output —
    asserted by tests); the python path below is the reference.
    """
    ref = np.asarray(ref, dtype=np.uint8)
    reads = [np.asarray(r, np.uint8) for r in reads]

    def once(mult: int) -> AssemblyResult:
        from falcon_genome_tpu.io import native_ext
        nat = native_ext.assemble_region(
            ref, reads, params.kmer_sizes, mult, params.max_haplotypes)
        if nat is not None:
            haps, k, fallback = nat
            return AssemblyResult(haps, k, fallback)
        p2 = dataclasses.replace(params, min_edge_mult=mult)
        return _assemble_region_py(ref, reads, p2)

    # Adaptive prune escalation (GATK's pruneFactor ladder).  Two
    # failure modes of a low multiplicity floor in noisy regions, both
    # found at the 10 Mb mutect2 rehearsal (55/62 misses had 10+ alt
    # reads):
    #  * SATURATION — the hap cap fills with combinatorial low-support
    #    error bubbles and selection past the cap arbitrarily drops a
    #    well-supported variant path;
    #  * BLOWUP — enumeration exceeds its path/step budget entirely
    #    (mutect2 starts at min_edge_mult=1 for low-VAF sensitivity:
    #    ~every sequencing error is a singleton bubble) and the region
    #    falls back to ref-only.
    # Raising the floor kills error bubbles first; real variants
    # (support ≫ the rung) survive.  A region that still falls back at
    # the top rung is genuinely unassemblable.
    # Adaptive prune escalation (GATK's pruneFactor ladder): raise the
    # floor on BLOWUP (enumeration budget exceeded → ref-only fallback)
    # and on SATURATION (cap filled — mostly floor-level error bubbles;
    # escalating kills them first and bounds the PairHMM pair count).
    # Unlike round 4, the selection WITHIN each rung is support-ordered,
    # so a real variant path (support above the rung) survives both the
    # cap and the escalation — without support-ordering, saturation
    # escalation dropped dense multi-het regions' variants arbitrarily;
    # without escalation, junk bubbles tripled the PairHMM wall (939 s vs
    # 629 s at the 60 Mb rehearsal).
    mult = params.min_edge_mult
    res = once(mult)
    while ((len(res.haplotypes) >= params.max_haplotypes or res.fallback)
           and mult < 8):
        mult += 1 if mult < 2 else 2
        res = once(mult)
    return res


def _assemble_region_py(ref: np.ndarray, reads: list[np.ndarray],
                        params: AssemblyParams) -> AssemblyResult:
    for k in params.kmer_sizes:
        graph, _ref_edges = _build_graph(ref, reads, k, params.min_edge_mult)
        if graph is None:
            break
        source = bytes(ref[:k - 1])
        sink = bytes(ref[-(k - 1):])
        if 4 in source or 4 in sink:
            break
        max_len = len(ref) + 64
        paths = _enumerate_paths(graph, source, sink, k, max_len)
        if paths is None:
            continue  # cyclic / blowup → larger k
        haps: list[np.ndarray] = [ref]
        seen = {bytes(ref)}
        # selection by SUPPORT when the region yields more paths than the
        # cap: a path's support is the weakest non-ref edge it crosses
        # (ref-only path → unbounded).  Dense multi-het regions exceed
        # the cap with genuine combination haplotypes (3 hets → 8 combos)
        # — lexicographic pick (round 4) arbitrarily dropped real variant
        # paths there, and prune-escalation killed their bubbles instead
        # of the error bubbles' (round-5 rehearsal: strong-evidence
        # misses in dense regions)
        def support(pth: bytes) -> int:
            s = 1 << 30
            for i in range(len(pth) - k + 1):
                node, nb = pth[i:i + k - 1], pth[i + k - 1]
                if (node, nb) not in _ref_edges:
                    s = min(s, graph[node][nb])
            return s
        scored = sorted(paths,
                        key=lambda s: (-support(s), len(s) != len(ref), s))
        for pth in scored:
            if pth in seen:
                continue
            seen.add(pth)
            haps.append(np.frombuffer(pth, dtype=np.uint8))
            if len(haps) >= params.max_haplotypes:
                break
        return AssemblyResult(haps, k, fallback=False)
    return AssemblyResult([ref], params.kmer_sizes[-1], fallback=True)
