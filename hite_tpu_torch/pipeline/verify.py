"""Shared family verification: copies -> clustering -> boundary rounds.

Host orchestration copied from the JAX package's `pipeline/verify.py`;
the device work it drives (copy joins, batched family analyses) is the
port's.

Common scaffolding of the TIR / Helitron / non-LTR modules (the reference
repeats this orchestration in each `judge_*_transposons.py`): retrieve
genome-wide copies for gated candidates, group candidates into families by
copy overlap, then iterate the dynamic-boundary-adjustment engine on each
family representative with a type-specific judge.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.ops.kmerset import kmer_code_set
from hite_tpu_torch.pipeline.boundary_adjust import (
    Judge, adjust_candidate,
)
from hite_tpu_torch.pipeline.candidates import CandidateSet
from hite_tpu_torch.pipeline.cluster import cluster_by_copies
from hite_tpu_torch.pipeline.copies import CopyFinder, CopyHit, GenomeIndex
from hite_tpu_torch.utils.log import count, logger, stage_timer


def shift_copies(genome: Genome, copies: List[CopyHit], dl: int,
                 dr: int) -> List[CopyHit]:
    """Move every copy's ends by the family's boundary deltas.

    A boundary round shifts the candidate interval by <= the search
    radius, which is far inside the flank-extended frames the copies were
    fetched with — so the round-N copies are the round-(N-1) copies with
    the same end deltas applied (strand-mirrored), no genome re-join
    needed.  The reference likewise fetches copies ONCE per
    flank_region_align_v5 invocation (Util.py:8077-8137); the previous
    implementation here re-joined the whole genome every round (~8 join
    chunks x 3 rounds x 3 modules at 100 Mbp).
    """
    L = len(genome.flat)
    out: List[CopyHit] = []
    for h in copies:
        if h.strand == 0:
            s, e = h.start + dl, h.end + dr
        else:
            s, e = h.start - dr, h.end - dl
        s, e = max(0, s), min(L, e)
        if e - s >= 30:
            out.append(CopyHit(start=s, end=e, strand=h.strand,
                               nseeds=h.nseeds))
    return out


@dataclass
class ModuleResult:
    """Output of one TE-class detection module."""

    accepted: CandidateSet
    consensus: List[np.ndarray]
    low_copy: CandidateSet
    copy_counts: List[int] = field(default_factory=list)


def empty_result() -> ModuleResult:
    empty = CandidateSet(intervals=np.zeros((0, 2), np.int64))
    return ModuleResult(accepted=empty, consensus=[], low_copy=empty)


@dataclass
class VerifyPlan:
    """Phase-1 output of verify_families: gated seqs + family reps.

    Lets the pipeline batch SEVERAL modules' representatives into ONE
    whole-genome copy-retrieval join (`run.py` gates TIR/Helitron/non-LTR
    first, joins the union, then finishes each module) — the reference
    pays one full minimap2 pass per module instead."""

    gated: np.ndarray
    seqs: List[np.ndarray]
    sim_groups: List[int]
    group_members: dict
    rep_idx: List[int]
    # rep_idx plus each similarity group's first ~2 ALTERNATE attempts
    # (by closeness to group median length — the order the boundary loop
    # will try them).  Fetching these in the ONE shared upfront join is
    # nearly free (join cost is genome-side dominated) and removes the
    # per-wave whole-genome joins the lazy alternate fetches paid inside
    # every module's boundary_adjust loop (round-5 profile: ~86% of the
    # three stages' wall was those joins).
    prefetch_idx: List[int] = field(default_factory=list)
    # sim-group -> co-members ordered closest-to-group-median-length
    # first; verify_families consumes this as the alternate attempt order
    # so the prefetched members above are exactly the ones attempted
    group_alt_order: dict = field(default_factory=dict)


def prepare_families(genome: Genome, gated: np.ndarray,
                     cfg: PipelineConfig) -> VerifyPlan:
    """Phase 1: similarity pre-cluster + representative selection.

    Pre-clusters candidates by sequence similarity BEFORE copy retrieval
    (the reference's cd-hit-est step, judge_TIR_transposons.py:87-89):
    only one representative per similarity group enters the whole-genome
    join — near-identical candidates (per-copy intervals of one family)
    would otherwise each pay a full-genome sort as separate join waves.
    """
    from hite_tpu_torch.pipeline.copies import _kmer_sketch_groups

    seqs = [genome.extract(s, e) for s, e in gated]
    # exact-8-mer min-hash Jaccard, NOT 4-mer-profile cosine: composition
    # cosine single-linkage-chains DISTINCT families on real genomes
    # (73/78 of test.ref at 0.35), and a distinct family absorbed as a
    # rep's "alternate" is only mapped if the rep fails — a recall bug.
    # k=8 + thresh 0.1 groups same-family copies to ~18% divergence while
    # unrelated pairs sit at J~0.01.  GREEDY linkage (cd-hit semantics):
    # single linkage let chimeric candidates (chains bridging two
    # adjacent planted copies of DIFFERENT families — common on dense
    # genomes) transitively merge whole families into one group with one
    # rep, silently dropping the others from the library.
    sim_groups = _kmer_sketch_groups(seqs, k=8, thresh=0.1,
                                     linkage="greedy", device=genome.device,
                                     span="modules.sketch")
    group_members: dict = {}
    for i, g in enumerate(sim_groups):
        group_members.setdefault(int(g), []).append(i)
    # representative = the member of MEDIAN length: chimeric candidates that
    # chain two adjacent copies are over-long outliers with few full-length
    # genomic copies (the old most-copies ranking rejected them; without
    # copy counts yet, median length is the robust proxy)
    def _median_member(idxs):
        order = sorted(idxs, key=lambda i: len(seqs[i]))
        return order[(len(order) - 1) // 2]

    rep_of_group = {g: _median_member(idxs)
                    for g, idxs in group_members.items()}
    rep_idx = sorted(rep_of_group.values())
    # per-group ALTERNATE attempt order (closest to group median length
    # first): verify_families uses exactly this order, so prefetching
    # each group's first two alternates into the shared upfront join
    # guarantees attempts 0-2 never pay an in-loop whole-genome join
    # (only data-dependent peel attempts fetch lazily)
    group_alt_order: dict = {}
    prefetch = set(rep_idx)
    for g, idxs in group_members.items():
        rep = rep_of_group[g]
        alts = [i for i in idxs if i != rep]
        med = np.median([len(seqs[i]) for i in alts]) if alts else 0
        order = sorted(alts, key=lambda i: abs(len(seqs[i]) - med))
        group_alt_order[g] = order
        prefetch.update(order[:2])
    return VerifyPlan(gated=gated, seqs=seqs, sim_groups=sim_groups,
                      group_members=group_members, rep_idx=rep_idx,
                      prefetch_idx=sorted(prefetch),
                      group_alt_order=group_alt_order)


def verify_families(
    genome: Genome,
    gated: np.ndarray,
    cfg: PipelineConfig,
    judge: Judge,
    *,
    min_copies: int,
    stage: str,
    gindex: Optional[GenomeIndex] = None,
    min_coverage: float = 0.9,
    plan: Optional[VerifyPlan] = None,
    rep_copy_sets: Optional[List[List[CopyHit]]] = None,
    mesh=None,
) -> ModuleResult:
    """Run the shared verification pipeline on gated candidate intervals.

    `plan` + `rep_copy_sets` inject phase-1 results whose representative
    copies were fetched in a shared multi-module join (see VerifyPlan).
    With `mesh` (`parallel.mesh.Mesh`), the batched family analyses shard
    their family axis over the mesh (bit-identical results)."""
    if len(gated) == 0:
        return empty_result()
    gindex = gindex or GenomeIndex(genome, cfg.align)
    finder = CopyFinder(gindex)

    if plan is None:
        plan = prepare_families(genome, gated, cfg)
    seqs = plan.seqs
    sim_groups = plan.sim_groups
    group_members = plan.group_members
    rep_idx = plan.rep_idx

    # the fetch set covers reps AND each group's first alternates (see
    # VerifyPlan.prefetch_idx); `rep_copy_sets` (when injected by the
    # shared multi-module join) is aligned with it
    fetch_idx = plan.prefetch_idx or rep_idx
    if rep_copy_sets is None:
        with stage_timer(f"{stage}.copies"):
            rep_copy_sets = finder.find_copies(
                [seqs[i] for i in fetch_idx],
                min_coverage=min_coverage, max_copies=cfg.msa.max_copies)
    if len(rep_copy_sets) != len(fetch_idx):
        raise ValueError(f"{len(rep_copy_sets)} injected copy sets for "
                         f"{len(fetch_idx)} fetched families")
    copy_sets: dict = dict(zip(fetch_idx, rep_copy_sets))

    groups = cluster_by_copies([copy_sets[i] for i in rep_idx])
    members: dict = {}
    for gi, g in enumerate(groups):
        members.setdefault(int(g), []).append(rep_idx[gi])
    # alternates: same-similarity-group co-members of each family's reps,
    # tried only if every representative fails.  The order interleaves
    # each rep's PER-SIM-GROUP median-closeness order (VerifyPlan.
    # group_alt_order) — the same order whose first two members the
    # shared upfront join prefetched, so attempts 0-2 never trigger an
    # in-loop whole-genome join
    alternates: dict = {}
    for g, idxs in members.items():
        seen_a: dict = {}
        for rep in idxs:
            for i in plan.group_alt_order.get(sim_groups[rep], ()):
                if i not in seen_a and i not in idxs:
                    seen_a[i] = None
        alternates[g] = list(seen_a)

    # PREFETCH alternates of families whose every rep is low-copy — those
    # families WILL try an alternate, and fetching them lazily cost one
    # whole-genome join per retry wave (~3 sequential joins per module at
    # 100 Mbp; this folds them into one upfront join).  Judge-rejection
    # retries stay lazy (not predictable here).
    need_alt = sorted({
        a
        for g, idxs in members.items()
        if all(len(copy_sets.get(i, ())) < min_copies for i in idxs)
        for a in alternates[g][:2] if a not in copy_sets})
    if need_alt:
        with stage_timer(f"{stage}.alt_copies"):
            for i, cs in zip(need_alt, finder.find_copies(
                    [seqs[i] for i in need_alt],
                    min_coverage=min_coverage,
                    max_copies=cfg.msa.max_copies)):
                copy_sets[i] = cs
    logger.info("%s: %d families from %d candidates (%d reps mapped)",
                stage, len(members), len(gated), len(rep_idx))

    accepted: List[Tuple[int, int]] = []
    consensus: List[np.ndarray] = []
    copy_counts: List[int] = []
    low_copy: List[Tuple[int, int]] = []

    with stage_timer(f"{stage}.boundary_adjust"):
        # Round-synchronous engine: every family's current interval is
        # analyzed in ONE batched device call per round, and every
        # changed interval's copy re-fetch rides ONE whole-genome join per
        # round.  The previous per-family loop issued one single-candidate
        # join per (family, round) — at 36 families x 3 rounds that was
        # the dominant line of the 8 Mbp hardware stage map.
        from hite_tpu_torch.pipeline.boundary_adjust import (
            analyze_families_batched,
        )

        ordered_members = {
            g: sorted(idxs, key=lambda i: (-len(copy_sets[i]),
                                           -(gated[i, 1] - gated[i, 0])))
            for g, idxs in members.items()
        }
        # universe: every candidate a group speaks for (reps + sim-group
        # co-members).  A similarity group can hold SEVERAL true families
        # (chimeric candidates attach distinct families to one founder on
        # dense genomes) — after a group resolves, members NOT explained
        # by the accepted family's genomic copies are PEELED into a fresh
        # family attempt instead of being silently dropped with it
        # (the reference's per-candidate loop never had this failure
        # mode: it judges every cd-hit rep independently).
        universe: dict = {}
        for g, idxs in members.items():
            seen_u: dict = {}
            for rep in idxs:
                for i in [rep] + alternates[g]:
                    seen_u.setdefault(i, None)
            universe[g] = list(seen_u)
        family_state: dict = {
            g: dict(order=(idxs + alternates[g])[:3], ai=0, low=None,
                    done=None, done_copies=None, root=g,
                    budget=3 + min(5, len(universe[g]) // 2))
            for g, idxs in ordered_members.items()
        }
        tried: dict = {g: set() for g in ordered_members}
        pending: List[Tuple[int, Tuple[int, int], list, int]] = []
        fetch_queue: List[Tuple[int, Tuple[int, int], int]] = []

        def on_copies(g, interval: Tuple[int, int], copies: list,
                      rnd: int) -> None:
            st = family_state[g]
            if len(copies) < min_copies:
                st["low"] = st["low"] or interval
                st["ai"] += 1
                begin_attempt(g)
            else:
                pending.append((g, interval, copies, rnd))

        def begin_attempt(g) -> None:
            st = family_state[g]
            root = st["root"]
            if st["done"] is not None or st["ai"] >= len(st["order"]) \
                    or family_state[root]["budget"] <= 0:
                finish_group(g)
                return
            family_state[root]["budget"] -= 1
            rep = st["order"][st["ai"]]
            tried[root].add(rep)
            interval = (int(gated[rep, 0]), int(gated[rep, 1]))
            if rep in copy_sets:
                on_copies(g, interval, copy_sets[rep], 0)
            else:
                fetch_queue.append((g, interval, 0))

        def superstring_of_accepted(cons: np.ndarray) -> bool:
            """True when `cons` largely CONTAINS an already-accepted
            family's consensus while being much longer — the signature
            of a chimeric candidate whose joint context happens to
            repeat.  Peeled acceptances with this signature are rejected
            (the tighter primary call wins; the chimera would otherwise
            absorb it in library clustering)."""
            if cons is None or len(cons) == 0:
                return False
            sk = kmer_code_set(cons, 16)
            if not len(sk):
                return False
            for st2 in family_state.values():
                done = st2["done"]
                if done is None or done.consensus is None:
                    continue
                a = done.consensus
                if len(cons) <= 1.3 * len(a):
                    continue
                ak = kmer_code_set(a, 16)
                if len(ak) and np.isin(ak, sk).mean() >= 0.5:
                    return True
            return False

        def finish_group(g) -> None:
            """Terminal state: peel unexplained co-members into a new
            family attempt (bounded by the root group's attempt budget)."""
            st = family_state[g]
            root = st["root"]
            if family_state[root]["budget"] <= 0:
                return
            spans = []
            if st["done"] is not None:
                spans.append((st["done"].start, st["done"].end))
                for h in st["done_copies"] or ():
                    spans.append((h.start, h.end))
            left = []
            for i in universe[root]:
                if i in tried[root]:
                    continue
                s, e = int(gated[i, 0]), int(gated[i, 1])
                explained = any(
                    min(e, pe) - max(s, ps) >= 0.5 * (e - s)
                    for ps, pe in spans)
                if explained:
                    tried[root].add(i)
                elif st["done"] is not None or not spans:
                    left.append(i)
            if not left:
                return
            order = sorted(left, key=lambda i: len(seqs[i]))
            med_len = len(seqs[order[(len(order) - 1) // 2]])
            # prefer an ALREADY-FETCHED member nearest the median length:
            # a peel rep outside copy_sets pays a whole-genome join wave,
            # and "closest to median among unexplained" is the same
            # robustness heuristic as "median of unexplained"
            fetched = [i for i in left if i in copy_sets]
            if fetched:
                rep = min(fetched, key=lambda i: abs(len(seqs[i]) - med_len))
            else:
                rep = order[(len(order) - 1) // 2]
            sub = ("peel", root, len(family_state))
            family_state[sub] = dict(order=[rep], ai=0, low=None,
                                     done=None, done_copies=None,
                                     root=root, budget=0)
            begin_attempt(sub)

        for g in ordered_members:
            begin_attempt(g)

        # the yield's numerator exists, at 0, for a module that finishes
        # no family
        count(f"{stage}.ba_done_items", 0)
        while pending or fetch_queue:
            if fetch_queue:
                fq, fetch_queue = fetch_queue, []
                count(f"{stage}.ba_fetch_waves")
                count(f"{stage}.ba_fetch_items", len(fq))
                with stage_timer(f"{stage}.ba_fetch"):
                    fetched = finder.find_copies(
                        [genome.extract(*it[1]) for it in fq],
                        min_coverage=min_coverage,
                        max_copies=cfg.msa.max_copies)
                for (g, interval, rnd), copies in zip(fq, fetched):
                    on_copies(g, interval, copies, rnd)
            if not pending:
                continue
            batch, pending = pending, []
            count(f"{stage}.ba_analyze_waves")
            count(f"{stage}.ba_analyze_items", len(batch))
            with stage_timer(f"{stage}.ba_analyze"):
                analyses = analyze_families_batched(
                    genome, [(it[1], it[2]) for it in batch], cfg.msa,
                    mesh=mesh, stage=stage)
            for (g, interval, copies, rnd), pre in zip(batch, analyses):
                st = family_state[g]
                result = adjust_candidate(genome, interval, copies, cfg.msa,
                                          judge, min_copies, precomputed=pre)
                if result.low_copy:
                    st["low"] = st["low"] or interval
                    st["ai"] += 1
                    begin_attempt(g)
                elif not result.accepted:
                    st["ai"] += 1
                    begin_attempt(g)
                else:
                    new_interval = (result.start, result.end)
                    if (new_interval == interval
                            or rnd + 1 >= cfg.msa.boundary_rounds):
                        too_long = (isinstance(g, tuple)
                                    and superstring_of_accepted(
                                        result.consensus))
                        if too_long:
                            st["ai"] += 1
                            begin_attempt(g)
                        elif result.end - result.start >= \
                                cfg.library.min_te_len:
                            st["done"] = result
                            st["done_copies"] = copies
                            count(f"{stage}.ba_done_items")
                            finish_group(g)
                        else:
                            st["ai"] += 1
                            begin_attempt(g)
                    else:
                        # next round reuses this round's copies with the
                        # boundary deltas applied — no genome re-join
                        moved = shift_copies(
                            genome, copies,
                            result.start - interval[0],
                            result.end - interval[1])
                        on_copies(g, new_interval, moved, rnd + 1)

        for g in list(family_state):     # root groups + peeled subfamilies
            st = family_state[g]
            result = st["done"]
            if result is not None:
                accepted.append((result.start, result.end))
                consensus.append(result.consensus)
                copy_counts.append(result.copy_count)
            elif st["low"] is not None and not isinstance(g, tuple):
                # peeled subs contribute ACCEPTED families only: a peel
                # that turns out low-copy is a leftover chimera/fragment,
                # and pooling it would hand structurally-plausible
                # chimeras (outer TIR termini of two member copies) to
                # the low-copy structural rescue
                low_copy.append(st["low"])

    return ModuleResult(
        accepted=CandidateSet(np.array(accepted, np.int64).reshape(-1, 2)),
        consensus=consensus,
        low_copy=CandidateSet(np.array(low_copy, np.int64).reshape(-1, 2)),
        copy_counts=copy_counts,
    )
