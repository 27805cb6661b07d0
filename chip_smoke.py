"""GPU smoke run of the PyTorch/CUDA port's main path (one NVIDIA card).

    python3 chip_smoke.py

Phases, one line each (or a few); any failure raises and exits non-zero:
  1. device   a CUDA card is required (nothing runs on the CPU); prints
              `nvidia-smi --query-gpu=name,power.limit` and the card's
              int32 issue rate (SMs x 128 per clock x the maximum SM
              clock; each bound also holds the FMA and ALU pipes to 64).
  2. build    compiles the kernel libraries with nvcc for sm_90a, one
              nvcc per library, all started together: the Poseidon2 sponge
              (csrc/poseidon2.cu), the NTT sub-transform (csrc/ntt.cu), the
              p254 sponge (csrc/poseidon254.cu), the MSM (csrc/msm.cu), the
              exact weighted sum (csrc/bbmm.cu; and the first design it
              is timed against, tools/bbmm_rows.cu), the trace upload
              (csrc/upload.cu) and
              the generated fused constraint kernels of both AIR variants
              (kernels/cons.py), plus the probes and the spin kernel of
              device_ms; prints nvcc
              seconds, registers, spills and blocks per SM, and for the
              two BN254 libraries and the weighted sum each kernel's
              registers, spills and stack frame.
  3. probe    independent chains of bb::mul and of bb::add on every SM:
              achieved operations and 32-bit instructions per second beside
              the published issue rate the bounds use; one warp's dependent
              chains of bb::mul, bb::add, a shuffle and a shuffle-and-add:
              clocks each, and the critical path of one
              permutation in every layout (p2_critical_path), which gives
              the sponge's latency bound; bn254::mul<Fr>'s dependent
              latency (clocks) and its products per second on every SM,
              which give the BN254 kernels' latency bounds.
  4. kernel   each kernel against its plain torch version on the card, bit
              for bit (tolerance 0: field words). Sponge: every layout (1,
              2, 4 and 8 lanes a hash) at N in SPONGE_CHECK_N and at each
              crossover of kernels/poseidon2.LANE_CROSSOVER +- 1, x C in
              SPONGE_CHECK_C ("init": a permutation of a state), the main
              path's sponge shapes, the chained leaf hash of a
              column-sharded commit (an init state and input columns, 24
              or 8 words out) at N in SPONGE_CHAIN_N x C in SPONGE_CHAIN_C
              in every layout (timed at SPONGE_CHAIN_TIMED with and
              without the state), pairs at 2^17, the tree top at every
              level size up to tree_max(), and every level of merkle.commit
              at 2^18 x 392 against the plain level loop. Times (device
              time, the host's cost hidden behind a spin kernel where
              launches are short) every layout at SPONGE_TIME_SHAPES beside
              the plain version (on at most PLAIN_TIMED_COLS columns), the
              throughput bound and the latency bound, and a whole commit
              with its leaves, levels and tree top apart, the plain level
              loop and tree top beside them (the sweeps of N for the crossovers and of the
              tree top's size are `tools/sponge_variants.py --sweep`).
              NTT: the sub-transform at M in {2, 64, 512, 1024} x L in {1,
              7, 128, 392}, both directions, with the four-step store; the
              whole four-step at the main path's transforms; the LDE glue
              the kernel folds in (coset_evaluate's
              zero-skip shifted load, intt's and coset_interpolate's scaled
              stores) at the main path's shapes. Times the NTT at 2^19 x
              392 (and each of its two launches) and the data LDE with CUDA
              events. Weighted sum ([bbmm], csrc/bbmm.cu): the kernel
              against its plain version, word for word, at BBMM_SHAPES:
              the DEEP combinations, α-combines (as the parent design's
              callers joined them), LogUp group and verifier rows the
              main, recursion and KeccakAir proofs pass, K = 1, M not a
              multiple of the block, K split over blocks and every word
              P - 1 at the widest K; and at BBMM_BLOCK_SHAPES, the column
              blocks the paths pass (the trees' matrices, the α-combine's
              items and ext items as they lie, a broadcast row), each
              call's launches (two when K is split); bb_weighted_sum_t
              must refuse the rv32i (K, M) constraint rows (there is no
              transposed kernel). At BBMM_TIMED the kernel and its first
              design (tools/bbmm_variants.py, timing only) in turns
              (device_ms), the plain ms, the bound and the reference's
              int8 limb product through torch._int_mm for scale (never
              on the path); at the block shapes the kernel beside the
              parent's route (torch.cat, then the first design).
              Trace upload ([upload], csrc/upload.cu; phase_upload): at
              each of the main path's shapes (the po2-20 witness's 392 of
              584 int64 columns read in place, the rv32im po2-20 witness's
              584 whole, a rec_po2-20 data trace's contiguous 64, the
              po2-17 witness) field.upload word for word against
              field.fp, one launch a staging block; its
              walls, the kernel's device time beside its bytes bound, the
              host route's wall. In no benchmark cell.
  5. golden   the port's po2-8 TEST_PS proofs on the card equal the JAX
              reference proofs stored in tests/data/torch_golden_po2_8.npz;
              every kernel launched in them; the fused constraint kernel's
              columns on both golden grids equal the plain version's.
  6. main     the loop guest at po2 17 (as bench.py): executor -> witness
              (the native C++ generator) -> prove_segment (100 queries,
              rate 1/2, rv32i) on the card, verify_segment accepts it and
              rejects a tampered claim. The launch counts are zeroed just
              before the executor and read right after the proof: sponge,
              NTT and constraint kernels must each be > 0 (the verifier's
              sponge launches are counted apart), and the eager α-combine
              (`cons_eval.combine_rows`) must not have run. Then the fused
              constraint kernel against its plain version on the proof's
              own 4N grid, bit for bit, and both timed. The sponge's
              launches by layout: lanes 1, 2 and 8 and the tree top must
              each be > 0. Then a second, warm proof and verify of the
              segment, apart from the timed ones, give the sponge's device
              time by kind (leaves, tree levels, tree top, transcript,
              verifier; SpongeProfile).
  6w. wide    an rv32im segment of po2 20 (the M-chain guest, WIDE_FILL of
              its cycles) through prove_segment at risc0's proof system
              (WIDE_PS_ARGS: 50 queries, rate 1/4), as the seg20-rv32im
              cell proves it: its data LDE is 2^22 x 584 words, past
              2^31. The launch counts are zeroed just before the proof
              and read right after it; every kernel must have launched,
              the upload once a staging block of (2^20, 584).
              verify_segment accepts the proof and rejects a tampered
              claim. Then each kernel at the shapes that proof gives it,
              against its plain route at tolerance 0 on WIDE_SAMPLES
              sampled columns or rows (the last ones among them, whose
              offsets lie past 2^31): the fused rv32im constraint kernel
              on the proof's own 4N grid (each sampled row with the row
              INV_RATE below it), the NTT sub-transform on the grid's
              data as a (1024, 2392064) tile, the four-step coset LDE of
              its first 2^20 rows (three launches, 1024, 64 and 64 rows)
              and its inverse back, the sponge's leaves of the grid, the
              proof's widest weighted sum (the DEEP combination) as it
              was called. One line a kernel with its shape, launches,
              device ms (the constraint kernel's with its wrapper's public
              pack and weights) and the plain route's ms on the samples;
              the proof's launches go into the kernel table.
  6a. audit   degree.assert_degrees on the card at po2 5, expand 16 (the
              coset LDE and the INTT through the NTT kernel) for rv32im,
              rv32i, RecursionAir and KeccakAir: every lane's degree equal
              to the JAX golden tests/data/torch_degree_golden.npz, NTT
              launches > 0; each AIR's constraints, worst degree, budget
              and seconds.
  6b. debug   debug.check_constraints on the card on [main]'s own po2-17
              rv32i witness: ok; with one rdv word of an active row bumped,
              failures that name the same constraints as the CPU plain path
              on a po2-8 loop-guest witness bumped the same way.
  6c. mesh    the main path's session (two po2-17 segments) proved by
              parallel/mesh.shard_batched_prover on a mesh of every card
              (dp; world size 1 on one card) and on a (1, 2) mesh naming
              the card twice (tp: each proof spread by trace columns,
              data 208 | 184, ctrl 32 | 8), and with several cards on a
              (1, count) mesh of distinct cards; each proof word for word
              equal to stark.prove of the same trace on the card; sponge,
              NTT and constraint kernel > 0 (and the weighted sum in the
              tp proofs), the data group's leaf hash chained through the
              sponge's initial state. Prints the tp walls, peaks and
              launches beside the single proofs' and the bytes moved
              between the tp group's positions.
  7. recursion the sponge at 2^21 x 64 in every layout, every level of its
              merkle.commit, and the NTT at 2^22 x 64 forward (three
              launches) bit for bit against their plain versions and
              timed; the port's production ROMs (rv32i lift of po2-17
              DEFAULT_PS segments, rec_po2-20 q50 join and resolve) equal
              the JAX package's sha256 digests in
              tests/data/torch_rec_golden.npz and their control IDs equal
              JAX's in tests/data/torch_control_golden.npz; then the
              chain: the main
              path's loop session (two po2-17 segments), prove_segment of
              both on the
              card, segment_pre_chains, SuccinctSystem at rec_po2 20
              (50 queries, rate 1/2, rv32i), lift both, join, finalize and
              verify_session. Every receipt verifies; a join receipt with
              one proof word bumped and a claim with post_pc changed are
              rejected. Launch counts are zeroed just before each proof and
              read right after: sponge and NTT > 0 in every proof, the
              constraint kernel > 0 in the segment proofs and 0 in the
              recursion proofs (RecursionAir takes the degree-split
              route), the sponge's 8-lane layout and tree top > 0 in every
              proof; every recursion data trace came from the native
              rec_eval. Prints the host seconds of each stage, the
              quotient stage's seconds, the peak device memory and the
              sponge's launches by layout of each recursion proof, and its
              device time by kind in one more, profiled lift.
  7a. povw    market/povw.WorkLog.record_receipt on [recursion]'s session
              receipt: verify_session on the card (sponge > 0), 2 << 17
              cycles credited; the same claim again and a forged
              post_segments refused; MintCalculator mints the closed epoch.
  8. coproc   the sponge at 2^11 x 4048 and the NTT at 2^11 x 4048 (with
              the LDE glue at the KeccakAir trace's 2^10 x 4048) bit for bit
              against their plain versions and timed; the keccak guest's
              po2-17 rv32im segment proof (DEFAULT_PS) with the fused
              constraint kernel checked on its 4N grid; the production ROMs
              of both lattices at rec_po2 21 (rv32im lift, join, resolve,
              lift_keccak at kec_po2 10 q50, union, and resolve_coproc built
              with the golden's placeholder constants) equal the JAX sha256
              digests of tests/data/torch_keccak_golden.npz and their
              control IDs JAX's in tests/data/torch_control_golden.npz,
              and the keccak circuit id equals JAX's; then the guest's
              batch as a KeccakAir
              proof, proved once more on a (1, 2) mesh naming the card
              twice (data 2032 | 2016) and equal to it word for word, ->
              lift_keccak, the segment -> lift, resolve_coproc ->
              finalize_session -> verify_session; then two chained random
              batches (42 + 17 permutations) -> lift_keccak each -> union
              over 0 -> 59. Tampers rejected: a bumped public state limb, a
              lift_keccak proof with one word bumped, a resolve_coproc claim
              with post_coproc changed; finalize_session on the undischarged
              lift raises, and so does a union in the wrong order. Launch
              counts are zeroed before each proof and read after: sponge and
              NTT > 0 in every proof, the constraint kernel > 0 only in the
              segment proof, the sponge's 8-lane layout and tree top > 0;
              every recursion data trace came from rec_eval. The sponge's
              device time by kind in one more, profiled KeccakAir proof
              and lift_keccak.
 9. cluster  two sessions submitted over localhost HTTP to the port's
              cluster (ClusterApi + make_http_server + BentoClient, worker
              threads of run_workers: exec 1, prove 2, join 1, aux 1, and
              coproc 1 for B; DEFAULT_PS, segment po2 17, device cuda),
              reusing the systems [recursion] and [coproc] built: A, the
              loop guest in CLUSTER_SEGMENTS po2-17 segments on the rv32i
              rec_po2-20 lattice (2 prove+lift tasks and a join; cut
              from 4 segments); B, the keccak guest on the coproc
              lattices at rec_po2 21 (keccak batch, lift_keccak,
              resolve_coproc). Each session
              runs first through a dev-mode cluster (DevModeSystem: the
              same claims, no proof); the real session's launch counts are
              zeroed just before its creation and read as it succeeds
              (sponge, NTT and constraint kernel > 0), every lift and join
              came from the native rec_eval, the downloaded receipt loads
              onto the card, verify_session accepts it, and its claim
              digest, journal and stats equal the dev-mode session's. A
              FAILED session fails the script with the task's error.
              Prints each session's wall from create to SUCCEEDED, the
              tasks and seconds of each stream (metrics.REGISTRY), the
              receipt's bytes, the peak device memory and the launches.
 10. market   signed requests through the port's market onto its
              cluster (ClusterContext: DEFAULT_PS, segment po2 17,
              succinct=None, the v1 aggregation seal; workers exec 1,
              prove 2, join 1, aux 1; device cuda), each order built by
              the requestor's Client, submitted to a MarketChain, priced,
              locked, proved through ClusterProver and fulfilled by a
              port Broker: (a) two loop-guest orders of MARKET_SEGMENTS
              po2-17 segments fulfilled per fill on a chain whose
              verifier is default_router(DEFAULT_PS, cuda) (the seal's
              host tensors move to the card and its segment STARKs are
              verified there); (b) two one-segment orders on a second
              chain (batch_fulfill, batch_size 2) fulfilled in one
              submit_root_and_fulfill after the in-guest ECDSA assessor
              (secp256k1_guest.assessor_ecdsa, native execution) checked
              both signatures. Every order must end FULFILLED with the
              executor's journal, the prover must be paid, each per-fill
              seal verified once and the batch's fills never. The launch
              counts are zeroed just before (a) and read just after (b):
              sponge, NTT and constraint kernel > 0. Then each seal of
              (a) again alone (stored on the host, verified on the card:
              its sponge launches > 0, its seconds), a seal with one
              flipped word of a segment's public io rejected on the card,
              and the assessor guest once more (cycles, seconds). Prints
              per order cycles, submit -> locked, submit -> fulfilled
              (market/bench.BenchRow; these include the broker's, the
              chain monitor's and ClusterProver's polls) and effective
              kHz; the prove stream's task seconds, the peak device
              memory and the launches.
 10a. services on [market]'s two chains: IndexerService syncs the events
              (requests, locks and fills equal to the phase's fills) and
              its localhost API's /stats equals them; Indexer agrees; a
              Slasher pass slashes nothing.
 11. p254     the p254 sponge (csrc/poseidon254.cu) against its plain
              version (the Python-int hash), bit for bit, in every layout:
              one thread and 3 lanes a hash at 2^10 rows x 48, 64, 24 and
              16 columns (the identity proof's groups) and on 2^10 pairs,
              the one-block tree top at every level size up to TREE_TOP,
              every level of a 2^10-leaf commit; sampled (spread rows and
              the last block) at the wrap's 2^16-row launches and on every
              level of a 2^16-leaf commit, its tree top included; the path
              walk of P254_PATHS opened paths of that commit in one
              launch, verify_rows accepting them, refusing a flipped
              sibling and raising on a sibling of x + r. Every layout must
              have launched. Device ms of a one-pair launch, of 2^16 x 64
              leaves, of the levels above them and of the whole commit,
              each beside its throughput bound (the dense schedule's count
              of the work) and its latency bound; the plain ms at 2^10 x
              64.
 12. msm      the BN254 MSM (csrc/msm.cu, signed 8-bit digits, bit-slice
              window sums) against its plain torch version at 2^10 points
              and against the host Pippenger (groth16/msm.py) at 2^12,
              with zero scalars, one, r - 1, digits of exactly 128 and of
              -127, repeated digits and points, a point and its negation
              under one scalar and a point under s and r - s, and a point
              at infinity; then P_i = i * G at 497 (a [groth16] call's
              size), 2^16, 2^18 and 2^20 points, where sum_i s_i P_i must
              equal (sum_i i s_i mod r) * G, and the kernel's device ms
              there beside its bound and latency bound; the plain ms at
              2^10.
 13. groth16  the CRS prover's path: a Merkle path of Poseidon-BN254 pair
              gadgets (depth GROTH16_DEPTH) as an R1CS, qap.setup_sparse
              (host) and qap.prove_sparse on the card; the proof verifies,
              a tampered public is refused, the MSM kernel launched.
 14. wrap     the JAX CI wrap chain (tests/test_groth16_wrap.py:20-44):
              echo guest words([1, 7]), seg po2 6, q2 / fri_min 16 / rate
              1/2, rec_po2 17: segment proof, lift, finalize_session,
              identity_p254 shrink (P254System.verify accepts it),
              wrap.compress(kind="groth16") and the pairing-only
              wrap.verify; the EVM seal round-trips; a tampered journal and
              a tampered claim are refused. Prints each stage's host
              seconds (after a synchronize), the p254 sponge's device ms
              and launches in the shrink (every layout must have run), R1CS
              rows and variables, the prover mode and the peak device
              memory.
The phases from [audit] on, less [recursion] and [coproc], print their
seconds. [main], [recursion] and [coproc] record the shapes and column
blocks of their weighted sums: every BBMM_SHAPES shape and every
BBMM_BLOCK_SHAPES table of a path must be among them, the
weighted-sum kernel must have launched on main, mesh, recursion, coproc,
cluster, market and wrap, and the plain version must have run on the
card only in the checks: [bbmm]'s, and the constraint kernel's plain
version (its α-combine is the plain weighted sum). The last two lines are
the kernel table (each kernel's launches on its own path, on the main
path for the segment prover's four kernels, in [wide]'s rv32im po2-20
proof (`launches_rv32im_po2_20`), [wrap] for the p254 sponge
and [groth16] for the MSM, and on every other path, [audit]'s, [mesh]'s,
[povw]'s, [cluster]'s and [market]'s included; max abs error, ms,
plain ms and bound ms; for the two BN254 kernels also the latency bound
and the products this design does) and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260
# The sponge against its plain version (tolerance 0) in every layout: rows
# (plus each crossover of kernels/poseidon2.LANE_CROSSOVER and its two
# neighbours) by columns ("init": one permutation of an initial state).
SPONGE_CHECK_N = (1, 2, 3, 31, 1000, 1 << 18)
SPONGE_CHECK_C = ("init", 7, 16, 17, 392, 3904, 4048)
LEAF_SHAPE = (1 << 18, 392)  # rv32i data group on the po2-17 commit domain
# The chained leaf hash of a column-sharded commit (`merkle.commit` over
# column blocks, the mesh's tp axis): a block's sponge from the (N, 24)
# state the block before left, the whole state out. Every layout at these
# rows by columns: the rv32i data group's tp-2 shards (208 | 184) and
# ctrl's last (8) on the po2-17 commit domain, a KeccakAir shard (2016).
SPONGE_CHAIN_N = (3, 1 << 11, (1 << 13) - 1, 1 << 13, (1 << 13) + 1, 1 << 18)
SPONGE_CHAIN_C = (8, 184, 208, 2016)
SPONGE_CHAIN_TIMED = (1 << 18, 208)
# The DEEP-tap absorb of a KeccakAir proof: 4 words a tap, two taps of each
# of its 32 + 4048 + 24 trace columns and one of the 16 check columns.
KEC_DEEP_WORDS = 4 * (2 * (32 + 4048 + 24) + 16)
# Timed sponge launches (what, rows, columns; 0 columns: a permutation).
SPONGE_TIME_SHAPES = (("transcript permute", 1, 0),
                      ("main DEEP absorb", 1, 3904),
                      ("KeccakAir DEEP absorb", 1, KEC_DEEP_WORDS),
                      ("KeccakAir leaves", 1 << 11, 4048),
                      ("main leaves", *LEAF_SHAPE))
# The plain version of a timed shape runs on at most this many columns: the
# KeccakAir DEEP absorb's 2,056 plain permutations one after another took
# about a minute of the script's time limit.
PLAIN_TIMED_COLS = 4096
# Sponge inputs of the po2-17 rv32i main path: ctrl / data / accum / check
# leaves on the 2^18-row commit domain, a FRI group matrix, the DEEP-tap
# transcript absorb, and opened rows at 100 queries.
MAIN_PATH_SHAPES = ((1 << 18, 40), LEAF_SHAPE, (1 << 18, 48), (1 << 18, 16),
                    (1 << 14, 64), (1, 3904), (100, 392))
NTT_SUB_M = (2, 64, 512, 1024)
NTT_SUB_L = (1, 7, 128, 392)
# (rows, columns, forward) of the po2-17 rv32i proof's transforms: trace
# interpolation of ctrl/data/accum, their 4N LDEs and the check LDE's
# 2^19 x 16 evaluate, and the quotient's 4N coset interpolation.
NTT_MAIN_SHAPES = ((1 << 17, 40, False), (1 << 17, 392, False),
                   (1 << 17, 48, False), (1 << 19, 40, True),
                   (1 << 19, 392, True), (1 << 19, 48, True),
                   (1 << 19, 16, True), (1 << 19, 4, False))
NTT_TIME_SHAPE = (1 << 19, 392)  # the data group's 4N evaluate
# (glue, rows in, columns, expand) of the po2-17 rv32i proof: trace
# interpolation (intt), the 4N LDEs, the check LDE at rate 1/2 and the
# quotient's coset interpolation, with the kernel's folded loads/stores.
NTT_GLUE_SHAPES = (("intt", 1 << 17, 392, 1),
                   ("coset_evaluate", 1 << 17, 40, 4),
                   ("coset_evaluate", 1 << 17, 392, 4),
                   ("coset_evaluate", 1 << 17, 48, 4),
                   ("coset_evaluate", 1 << 17, 16, 2),
                   ("coset_interpolate", 1 << 19, 4, 1))
# The exact weighted sum (core/bbmm.py) at the shapes its paths give it:
# (what, path, M, K, W). K and W are those the port's proofs
# pass (K does not change with the size; [main], [recursion] and [coproc]
# record the shapes of their calls and every shape of a path must be
# among them): the main proof's DEEP combination (ctrl + data + accum =
# 480 columns weighed at z and zg together, then the 16 check columns)
# and its LogUp accumulator's widest group; the verifier's opened rows at
# 100 queries (z and zg apart); a rec_po2-20 lift's α-combine on its 4N,
# 2N and N grids and its DEEP combination; KeccakAir's at kec_po2 10.
# Then the edge cases: K = 1, M not a multiple of the kernel's 64-row
# block, every word P - 1 at the widest K of each width ("max"), K split
# over blocks (192 rows) and one word past a block's longest slice.
BBMM_SHAPES = (("main DEEP z+zg", "main", 1 << 18, 480, 8),
               ("main DEEP check", "main", 1 << 18, 16, 4),
               ("main accum group", "main", 1 << 17, 27, 4),
               ("main verify rows", "verify", 100, 480, 4),
               ("lift alpha 4N", None, 1 << 22, 73, 4),
               ("lift alpha 2N", None, 1 << 21, 53, 4),
               ("lift alpha N", None, 1 << 20, 55, 4),
               ("lift DEEP z+zg", "recursion", 1 << 21, 136, 8),
               ("KeccakAir alpha 4N", None, 1 << 12, 8080, 4),
               ("KeccakAir DEEP z+zg", "keccak", 1 << 11, 4104, 8),
               ("K=1", None, 1000, 1, 4),
               ("M=2^17+3", None, (1 << 17) + 3, 33, 8),
               ("max KeccakAir alpha", None, 1 << 12, 8080, 4),
               ("max KeccakAir DEEP", None, 1 << 11, 4104, 8),
               ("split 192 rows", None, 192, 480, 8),
               ("K=SLICE_MAX+1", None, 1 << 12, 4097, 4))
# The α-combine shapes above are the base columns alone, as the callers
# joined them before the ext items entered the sum; the paths now pass
# column blocks: (what, path, M, ((width, row stride), ...), W), row stride
# 0 a broadcast row. A DEEP combination reads the trees' matrices (ctrl,
# data, accum) in place; an α-combine its items as they lie, VecVals'
# (M, G) matrices and base columns (M, 1) in item order, then each ExtVal's
# (M, 4) coordinates (under α^k X^i). [main], [recursion] and [coproc]
# record the tables of their calls; each table of a path must be among
# them.
BBMM_BLOCK_SHAPES = (
    ("main DEEP z+zg blocks", "main", 1 << 18,
     ((40, 40), (392, 392), (48, 48)), 8),
    ("lift alpha 4N blocks", "recursion", 1 << 22,
     ((24, 24), (24, 24), (1, 1), (24, 24), (4, 4)), 4),
    ("lift alpha 2N blocks", "recursion", 1 << 21,
     ((1, 1), (24, 24), (1, 1), (1, 1), (1, 1), (1, 1), (24, 24), (4, 4)), 4),
    ("lift alpha N blocks", "recursion", 1 << 20,
     ((3, 3), (1, 1), (1, 1), (1, 1), (1, 1), (24, 24), (24, 24))
     + ((4, 4),) * 9, 4),
    ("lift DEEP z+zg blocks", "recursion", 1 << 21,
     ((48, 48), (64, 64), (24, 24)), 8),
    ("KeccakAir alpha 4N blocks", "keccak", 1 << 12,
     ((3840, 3840), (320, 320), (320, 320), (1600, 1600), (1600, 1600))
     + ((100, 100),) * 4 + ((4, 4),) * 8, 4),
    ("KeccakAir DEEP z+zg blocks", "keccak", 1 << 11,
     ((32, 32), (4048, 4048), (24, 24)), 8),
    ("broadcast rows, strided blocks", None, 1000,
     ((24, 30), (1, 0), (4, 4), (7, 0), (5, 9)), 8))
BBMM_TIMED = ("main DEEP z+zg", "main DEEP check", "main verify rows",
              "lift alpha 4N", "lift DEEP z+zg", "KeccakAir alpha 4N",
              "KeccakAir DEEP z+zg")
# The (K, M) constraint rows of the rv32i 4N grid, two classes: the shape
# `cons_eval.combine_rows` gives bb_weighted_sum_t, which only the CPU and
# the constraint kernel's plain version run; on the card it must refuse.
BBMM_TRANSPOSED_REFUSED = (773, 1 << 19, 8)
BBMM_SEEN: dict = {}  # path -> {(M, K, W)} of its calls
BBMM_TABLES_SEEN: dict = {}  # path -> {(M, ((width, ld), ...), W)}
PLAIN_IN_CONS_CHECKS = 0  # plain weighted sums on the card in PlainBbmm
MAIN_PO2 = 17
REC_PO2 = 20  # the recursion proofs' rows (the lift is 1,035,939 wire rows)
# The recursion proofs' system: 50 queries at rate 1/2 (the JAX package's
# production sizing, docs/ROUND5.md; the segments use DEFAULT_PS).
REC_PS_ARGS = dict(queries=50, fri_min_degree=256, commit_expand=2)
REC_SPONGE_SHAPE = (1 << 21, 64)  # the data group on the rec commit domain
REC_NTT_SHAPE = (1 << 22, 64)  # the data group's 4N evaluate
REC_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rec_golden.npz")
# The JAX control IDs of the production programs (rec20/<kind>: the rv32i
# lattice at rec_po2 20; rec21/<kind>: the rv32im and coproc lattices at
# 21, resolve_coproc with the placeholder constants), from
# tests/data/make_torch_control_golden.py.
CONTROL_GOLDEN = os.path.join(ROOT, "tests", "data",
                              "torch_control_golden.npz")
# The keccak coprocessor phase: KeccakAir batches at kec_po2 10 (42
# permutations, 4048 data columns) under the recursion's q50 system, and
# both lattices at rec_po2 21 (the rv32im lift of a po2-17 DEFAULT_PS
# segment is 1,175,747 wire rows, lift_keccak 1,779,976).
KEC_PO2 = 10
COPROC_REC_PO2 = 21
KEC_TRACE_SHAPE = (1 << 10, 4048)  # the data trace (interpolation, LDE)
KEC_SPONGE_SHAPE = (1 << 11, 4048)  # the data leaves on the commit domain
KEC_NTT_SHAPE = (1 << 11, 4048)
UNION_PERMS = (42, 17)  # two chained batches, united
KEC_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_keccak_golden.npz")
INV_RATE_GRID = 4  # the constraint grid's blowup (the 4N LDE)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer issue of one sm_90 SM per clock: 64 on the FMA-heavy pipe
# (IMAD*), 64 on the ALU pipe (ISETP, IADD3, SEL) (CUDA C++ Programming
# Guide, arithmetic throughput table, compute capability 9.0; Nsight
# Compute's pipe list), and at most 128 thread-instructions in all: four
# schedulers issue one warp instruction each (H100 whitepaper).
PIPE_PER_CLOCK_PER_SM, ISSUE_PER_CLOCK_PER_SM = 64, 128
# 32-bit instructions of one Baby Bear operation as (FMA pipe only, ALU
# pipe only, either pipe), the sequence nvcc emits for csrc/babybear.cuh
# on sm_90a (tools/sass_mix.py): a Montgomery product is IMAD.WIDE.U32,
# IMAD, IMAD.HI.U32, an add (the carry) and one VIADDMNMX (the final
# subtraction and min, ALU only); a modular add is an add and a VIADDMNMX.
# An add may issue on either pipe (IADD3 or IMAD.IADD).
MUL_MIX, ADD_MIX = (3, 1, 1), (0, 1, 1)
# One Poseidon2 permutation in csrc/poseidon2.cu: 8 external rounds (24
# S-boxes of 4 products, 24 constant adds, the 128-add external linear
# layer), 21 internal rounds (one S-box, the 24 diagonal products, 48
# adds) and the initial external linear layer.
P2_MULS = 8 * 24 * 4 + 21 * (4 + 24)
P2_ADDS = 128 + 8 * (24 + 128) + 21 * 48


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def rand_words(rng, shape, device):
    """Uniform Montgomery words in [0, P) as an int32 tensor."""
    from boundless_tpu_torch.core import field as F

    return torch.from_numpy(rng.integers(0, F.P, size=shape, dtype=np.int64)
                            .astype(np.int32)).to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Checker:
    """Bit-for-bit comparisons of a kernel with its plain version."""

    def __init__(self):
        self.max_err = 0
        self.checked = 0

    def __call__(self, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_err = max(self.max_err, err)
        self.checked += 1
        if err:
            raise AssertionError(f"{what}: kernel differs from plain torch")


def bound_ms(nbytes: float, muls: float, adds: float, sm_clocks_per_s: float,
             extra=(0, 0, 0)):
    """The least time the card could take for `muls` Baby Bear products
    and `adds` adds or subtracts (plus `extra` (FMA, ALU, either)
    instructions) over `nbytes` of memory traffic: the larger of the
    bytes' time and the slowest of the FMA pipe, the ALU pipe and the
    issue limit, at MUL_MIX and ADD_MIX instructions an operation. -> (ms,
    "bytes" or "operations")."""
    fma, alu, either = (muls * m + adds * a + e
                        for m, a, e in zip(MUL_MIX, ADD_MIX, extra))
    t_ops = max(fma / PIPE_PER_CLOCK_PER_SM, alu / PIPE_PER_CLOCK_PER_SM,
                (fma + alu + either) / ISSUE_PER_CLOCK_PER_SM) / sm_clocks_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clocks_per_s = sms * float(clock) * 1e6
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, sms=sms, max_sm_mhz=clock,
        int32_issue_per_s=f"{sm_clocks_per_s * ISSUE_PER_CLOCK_PER_SM:.4e}")
    return sm_clocks_per_s


def phase_build():
    """One nvcc per library, all started together."""
    from boundless_tpu_torch.kernels import bbmm as BK
    from boundless_tpu_torch.kernels import build
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import msm as MK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.kernels import poseidon254 as P254K
    from boundless_tpu_torch.kernels import upload as UK
    from boundless_tpu_torch.zkvm import prove

    jobs = {"bt_poseidon2": P2K._lib, "bt_ntt": NK._lib,
            "bt_poseidon254": P254K._lib, "bt_msm": MK._lib,
            "bt_bbmm": BK._lib, "bt_bbmm_rows": bbmm_variants().load_rows,
            "bt_upload": UK._lib,
            "bt_issue_probe": probe_lib, "bt_spin": spin_lib,
            "bt_bn_probe": bn_probe_lib}
    for variant, air in prove._AIRS.items():
        jobs[f"bt_cons_{variant}"] = (lambda a=air: CK.build_kernels(a))
    errors = {}

    def run(name, fn):
        try:
            fn()
        except Exception as e:  # reported below, after every build
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    occupancy = {}
    if not errors:
        # blocks per SM of the NTT at its two four-step sizes and of each
        # fused constraint kernel
        occupancy["bt_ntt"] = (f"m1024:{NK.blocks_per_sm(10)},"
                               f"m512:{NK.blocks_per_sm(9)}")
        for variant, air in prove._AIRS.items():
            occupancy[f"bt_cons_{variant}"] = CK.blocks_per_sm(air)
        occupancy["bt_bbmm"] = f"w4:{BK.blocks_per_sm(4)},w8:{BK.blocks_per_sm(8)}"
    for name in jobs:
        log = build.PTXAS_LOG.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        say("build", library=name, arch="sm_90a",
            nvcc_seconds=f"{build.BUILD_SECONDS.get(name, 0.0):.3f}",
            functions=len(regs), max_registers=max(regs, default=0),
            spill_store_bytes=sum(spills),
            blocks_per_sm=occupancy.get(name, "-"), ok=name not in errors)
    if "bt_ntt" in build.PTXAS_LOG:  # registers by sub-transform size
        regs = re.findall(r"Compiling entry function '\S*sub_ntt_kernel"
                          r"ILi(\d+)E\S*'.*?Used (\d+) registers",
                          build.PTXAS_LOG["bt_ntt"], re.S)
        say("build", library="bt_ntt",
            registers_by_log_m=",".join(f"{lm}:{n}" for lm, n in regs))
    if "bt_poseidon2" in build.PTXAS_LOG:  # registers, spills by layout
        log = build.PTXAS_LOG["bt_poseidon2"]
        funcs = re.findall(r"Compiling entry function '(\S*(?:sponge_kernelILi"
                           r"(\d)E|tree_kernel)\S*)'.*?(\d+) bytes spill "
                           r"stores.*?Used (\d+) registers", log, re.S)
        lanes = {"6": "lanes1", "3": "lanes2", "2": "lanes4", "1": "lanes8"}
        say("build", library="bt_poseidon2", registers_spill_bytes=",".join(
            f"{lanes.get(k, 'tree_top')}:{regs}/{spill}"
            for _, k, spill, regs in funcs))
    for name in ("bt_poseidon254", "bt_msm", "bt_bbmm", "bt_bbmm_rows",
                 "bt_upload"):
        if name in build.PTXAS_LOG:
            say("build", library=name, registers_spill_stack_bytes=
                ptxas_summary(build.PTXAS_LOG[name]))
    say("build", parallel_wall_seconds=f"{wall:.3f}")
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"build of {name} failed") from err


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "babybear.cuh"
// CHAINS independent chains a thread of one Baby Bear operation.
constexpr int CHAINS = 8;
template <int OP>
__global__ void chains(uint32_t* x, unsigned iters) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t b = x[i] % bb::P;
  uint32_t a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = (x[i] + k) % bb::P;
  for (unsigned t = 0; t < iters; ++t) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      a[k] = OP ? bb::add(a[k], b) : bb::mul(a[k], b);
  }
  uint32_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= a[k];
  x[i] = s;
}
extern "C" int bt_probe(int op, uint32_t* x, unsigned blocks,
                        unsigned threads, unsigned iters, void* stream) {
  if (op) chains<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, iters);
  else chains<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, iters);
  return (int)cudaGetLastError();
}
// One warp, one dependent chain a lane: clocks per operation in clk[lane].
// OP 0: bb::mul, 1: bb::add, 2: __shfl_xor_sync, 3: the sponge's group-sum
// step bb::add(v, __shfl_xor_sync(v)).
template <int OP>
__global__ void latency(uint32_t* x, long long* clk, unsigned iters) {
  const unsigned t = threadIdx.x;
  uint32_t v = x[t] % bb::P;
  const uint32_t b = (x[t] + 7) % bb::P;
  const long long t0 = clock64();
  for (unsigned i = 0; i < iters; ++i) {
    if (OP == 0) v = bb::mul(v, b);
    else if (OP == 1) v = bb::add(v, b);
    else if (OP == 2) v = __shfl_xor_sync(0xffffffffu, v, 1);
    else v = bb::add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  }
  const long long t1 = clock64();
  x[t] = v;
  clk[t] = t1 - t0;
}
template <int OP>
void run_latency(uint32_t* x, long long* clk, unsigned iters, cudaStream_t s) {
  latency<OP><<<1, 32, 0, s>>>(x, clk, iters);
}
extern "C" int bt_latency(int op, uint32_t* x, long long* clk,
                          unsigned iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: run_latency<0>(x, clk, iters, s); break;
    case 1: run_latency<1>(x, clk, iters, s); break;
    case 2: run_latency<2>(x, clk, iters, s); break;
    default: run_latency<3>(x, clk, iters, s); break;
  }
  return (int)cudaGetLastError();
}
"""
# Holds the stream for `clocks` SM clocks, so that the host can queue work
# behind it (device_ms). Its own library: it needs nothing of the port.
SPIN_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void spin(long long clocks) {
  const long long t0 = clock64();
  while (clock64() - t0 < clocks) {
  }
}
extern "C" int bt_spin(long long clocks, void* stream) {
  spin<<<1, 1, 0, (cudaStream_t)stream>>>(clocks);
  return (int)cudaGetLastError();
}
"""
PROBE_CHAINS, PROBE_ITERS, PROBE_THREADS = 8, 2048, 256
# bn254::mul<Fr> (csrc/bn254_field.cuh): one warp's dependent chains (SM
# clocks a product) and BN_CHAINS independent chains a thread on every SM
# (products per second). tools/bn254_profile.py builds it against another
# tree's header too.
BN_PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "bn254_field.cuh"
using bn254::Fr;
__device__ __forceinline__ void start(uint32_t a[8], const uint32_t* x) {
  for (int k = 0; k < 8; ++k) a[k] = x[k];
  a[7] &= 0x0fffffffu;  // below r
}
__global__ void latency(uint32_t* x, long long* clk, unsigned iters) {
  const unsigned t = threadIdx.x;
  uint32_t a[8], b[8];
  start(a, x + 16 * t);
  start(b, x + 16 * t + 8);
  const long long t0 = clock64();
  for (unsigned i = 0; i < iters; ++i) bn254::mul<Fr>(a, a, b);
  const long long t1 = clock64();
  for (int k = 0; k < 8; ++k) x[16 * t + k] = a[k];
  clk[t] = t1 - t0;
}
constexpr int CHAINS = 4;
__global__ void throughput(uint32_t* x, unsigned iters) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[CHAINS][8], b[8];
  start(b, x + 16 * t + 8);
  for (int c = 0; c < CHAINS; ++c) {
    start(a[c], x + 16 * t);
    a[c][0] ^= c;
  }
  for (unsigned i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) bn254::mul<Fr>(a[c], a[c], b);
  }
  for (int c = 1; c < CHAINS; ++c)
    for (int k = 0; k < 8; ++k) a[0][k] ^= a[c][k];
  for (int k = 0; k < 8; ++k) x[16 * t + k] = a[0][k];
}
extern "C" int bt_mul_latency(uint32_t* x, long long* clk, unsigned iters,
                              void* stream) {
  latency<<<1, 32, 0, (cudaStream_t)stream>>>(x, clk, iters);
  return (int)cudaGetLastError();
}
extern "C" int bt_mul_throughput(uint32_t* x, unsigned blocks,
                                 unsigned threads, unsigned iters,
                                 void* stream) {
  throughput<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, iters);
  return (int)cudaGetLastError();
}
"""
BN_CHAINS, BN_ITERS, BN_LATENCY_ITERS, BN_THREADS = 4, 64, 256, 128
LATENCY_ITERS = 4096
LATENCY_OPS = ("mul", "add", "shfl", "shfl_add")


def probe_lib():
    import ctypes

    from boundless_tpu_torch.kernels import build

    lib = build.load_source("bt_issue_probe", lambda: PROBE_SOURCE)
    vp, u = ctypes.c_void_p, ctypes.c_uint
    lib.bt_probe.argtypes = [ctypes.c_int, vp, u, u, u, vp]
    lib.bt_probe.restype = ctypes.c_int
    lib.bt_latency.argtypes = [ctypes.c_int, vp, vp, u, vp]
    lib.bt_latency.restype = ctypes.c_int
    return lib


def spin_lib():
    import ctypes

    from boundless_tpu_torch.kernels import build

    lib = build.load_source("bt_spin", lambda: SPIN_SOURCE)
    lib.bt_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    lib.bt_spin.restype = ctypes.c_int
    return lib


def bn_probe_lib():
    import ctypes

    from boundless_tpu_torch.kernels import build

    lib = build.load_source("bt_bn_probe", lambda: BN_PROBE_SOURCE)
    vp, u = ctypes.c_void_p, ctypes.c_uint
    lib.bt_mul_latency.argtypes = [vp, vp, u, vp]
    lib.bt_mul_latency.restype = ctypes.c_int
    lib.bt_mul_throughput.argtypes = [vp, u, u, u, vp]
    lib.bt_mul_throughput.restype = ctypes.c_int
    return lib


def bn_mul_probe(lib, dev, sm_clocks_per_s) -> dict:
    """bn254::mul<Fr>: the dependent latency of one product (SM clocks,
    one warp, one chain a lane) and the products per second of
    independent chains on every SM."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * 2048 // BN_THREADS
    x = torch.randint(0, 1 << 31, (blocks * BN_THREADS * 16,),
                      dtype=torch.int32, device=dev)
    clk = torch.zeros(32, dtype=torch.int64, device=dev)
    for _ in range(2):  # the first run warms the instruction cache
        if lib.bt_mul_latency(x.data_ptr(), clk.data_ptr(), BN_LATENCY_ITERS,
                              stream):
            raise RuntimeError("bn254 latency probe launch failed")
    torch.cuda.synchronize()
    latency = float(clk.max()) / BN_LATENCY_ITERS

    def run():
        if lib.bt_mul_throughput(x.data_ptr(), blocks, BN_THREADS, BN_ITERS,
                                 stream):
            raise RuntimeError("bn254 throughput probe launch failed")

    ms = cuda_ms(run, 5)
    per_s = blocks * BN_THREADS * BN_CHAINS * BN_ITERS / (ms * 1e-3)
    return {"bn_mul_latency_clocks": latency, "bn_mul_products_per_s": per_s,
            "bn_mul_sm_clocks_per_product": sm_clocks_per_s / per_s}


def ptxas_summary(log: str) -> str:
    """kernel:registers/spill-store bytes/stack-frame bytes for each entry
    function of a ptxas -v report."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)"
                               r"(?=Compiling entry function|\Z)", log, re.S):
        vals = [re.search(pat, body) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes spill stores",
            r"(\d+) bytes stack frame")]
        out.append(kernel_name(fn) + ":" + "/".join(
            v.group(1) if v else "?" for v in vals))
    return ",".join(out)


def kernel_name(mangled: str) -> str:
    """The `..._kernel` component of a mangled entry name (its length
    prefix decides where it starts), else the name as it is."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end(): m.end() + int(m.group())]
        if name.endswith("_kernel"):
            return name
    return mangled


def device_ms(fn, reps: int, sm_hz: float = 1.98e9) -> float:
    """Mean device milliseconds of `fn` over `reps` runs, with the host's
    cost per call hidden: a spin kernel holds the stream while the host
    queues all `reps` calls, so the card runs them back to back (a call
    that launches one small kernel costs the host more time than the card,
    and `cuda_ms` then measures the host). The spin lasts twice the host's
    own time for the calls plus 2 ms; were the host still queueing when it
    ends, the gap would show in the time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    lib = spin_lib()
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rc = lib.bt_spin(int((2 * host_s + 2e-3) * sm_hz), stream)
    if rc:
        raise RuntimeError(f"spin launch failed: CUDA error {rc}")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_probe(dev, sm_clocks_per_s):
    """Achieved Baby Bear operations per second in independent chains on
    every SM, and the 32-bit instructions per second they imply at the
    bound's mix (MUL_MIX, ADD_MIX), beside the published issue rate."""
    lib = probe_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * 2048 // PROBE_THREADS  # every SM full of threads
    x = torch.arange(blocks * PROBE_THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops = blocks * PROBE_THREADS * PROBE_ITERS * PROBE_CHAINS
    for op, name, mix in ((0, "mul", MUL_MIX), (1, "add", ADD_MIX)):
        def run():
            rc = lib.bt_probe(op, x.data_ptr(), blocks, PROBE_THREADS,
                              PROBE_ITERS, stream)
            if rc:
                raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        ms = cuda_ms(run, 5)
        per_s = ops / (ms * 1e-3)
        say("probe", op=name, chains_per_thread=PROBE_CHAINS,
            threads=blocks * PROBE_THREADS, ms=f"{ms:.4f}",
            ops_per_s=f"{per_s:.4e}", instructions_per_op=sum(mix),
            int32_instructions_per_s=f"{per_s * sum(mix):.4e}",
            published_issue_per_s=f"{sm_clocks_per_s * ISSUE_PER_CLOCK_PER_SM:.4e}")
    x = torch.arange(32, dtype=torch.int32, device=dev)
    clk = torch.zeros(32, dtype=torch.int64, device=dev)
    lat = {}
    for op, name in enumerate(LATENCY_OPS):
        for _ in range(2):  # the first run warms the instruction cache
            rc = lib.bt_latency(op, x.data_ptr(), clk.data_ptr(),
                                LATENCY_ITERS, stream)
            if rc:
                raise RuntimeError(f"latency launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
        lat[name] = float(clk.max()) / LATENCY_ITERS
    say("probe", latency="one warp, one dependent chain a lane",
        **{f"{k}_clocks": f"{v:.2f}" for k, v in lat.items()},
        **{f"permutation_critical_path_clocks_lanes{g}":
           f"{p2_critical_path(g, lat):.0f}" for g in (1, 2, 4, 8)})
    bn = bn_mul_probe(bn_probe_lib(), dev, sm_clocks_per_s)
    lat["bn_mul"] = bn["bn_mul_latency_clocks"]
    lat["sm_hz"] = sm_clocks_per_s / sms
    say("probe", op="bn254::mul<Fr>",
        latency_clocks=f"{bn['bn_mul_latency_clocks']:.1f}",
        products_per_s=f"{bn['bn_mul_products_per_s']:.4e}",
        sm_clocks_per_product=f"{bn['bn_mul_sm_clocks_per_product']:.2f}",
        p254_permutation_critical_path_clocks=
        f"{P254_PERM_DEPTH * lat['bn_mul']:.0f}")
    return lat


def p2_critical_path(lanes: int, lat: dict) -> float:
    """Clocks on the critical path of one permutation at `lanes` lanes a
    hash (csrc/poseidon2.cu), from the probe's dependent latencies. The
    external linear layer: M4 (5 adds deep), the tree of a lane's K chunk
    sums, log2(lanes) shuffle-and-add steps and the add of the sum; an
    external round: the constant's add, the S-box (4 products) and the
    linear layer; an internal round (either scheme): the add of S to word
    0, the constant's add, the S-box and the add of the rest of the sum;
    a lane group also broadcasts word 0 and sums the group once."""
    k = {1: 6, 2: 3, 4: 2, 8: 1}[lanes]
    steps = lanes.bit_length() - 1
    mul, add, step = lat["mul"], lat["add"], lat["shfl_add"]
    linear = (5 + (k - 1).bit_length() + 1) * add + steps * step
    external = add + 4 * mul + linear
    internal = 4 * mul + 3 * add
    prologue = (lat["shfl"] + steps * step) if lanes > 1 else 0.0
    return linear + 8 * external + 21 * internal + prologue + add


def latency_bound_ms(chain: int, lanes: int, lat: dict,
                     sm_hz: float) -> float:
    """The least time of a launch whose hashes are chains of `chain`
    dependent permutations: the chain times a permutation's critical path
    (each hash has at least that much latency, whatever runs beside it)."""
    return chain * p2_critical_path(lanes, lat) / sm_hz * 1e3


def sponge_bounds(n: int, c: int, lanes: int, sm_clocks_per_s: float,
                  lat: dict):
    """(throughput bound ms, its "bytes"/"operations", latency bound ms) of
    a sponge launch over n rows of c columns (c = 0: a permutation of a
    24-word state, all 24 words out)."""
    from boundless_tpu_torch.core import poseidon2 as P2

    chain = max(1, -(-c // P2.RATE))
    words = (c + P2.DIGEST_WORDS) if c else 2 * P2.WIDTH
    bms, by = bound_ms(4 * n * words, n * chain * P2_MULS,
                       n * chain * P2_ADDS + n * c, sm_clocks_per_s)
    sm_hz = sm_clocks_per_s / torch.cuda.get_device_properties(
        0).multi_processor_count
    return bms, by, latency_bound_ms(chain, lanes, lat, sm_hz)


def sponge_ms(fn, n: int, c: int) -> float:
    """Device ms of a sponge call: with the host's cost hidden for short
    launches (device_ms), by CUDA events alone for long ones (a chain of 64
    or more permutations, or over 2^20 in all)."""
    chain = max(1, -(-c // 16))
    if chain >= 64 or n * chain > (1 << 20):
        return cuda_ms(fn, 5)
    return device_ms(fn, max(3, min(50, (1 << 20) // (n * chain))))


def once_ms(fn) -> float:
    """Device ms of one call (CUDA events; no warm-up run)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def hash_lanes(x, lanes: int):
    """`hash_rows` on the card in a forced layout (`lanes` lanes a hash)."""
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    return P2K._sponge(x, None, P2.DIGEST_WORDS, lanes)


def permute_lanes(states, lanes: int):
    """`permute` on the card in a forced layout."""
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    return P2K._sponge(states.new_empty((states.shape[0], 0)), states,
                       P2.WIDTH, lanes)


def check_commit(x, check, what):
    """merkle.commit on the card: every level against the plain level loop
    (the plain sponge's leaves, then core/poseidon2.hash_tree)."""
    from boundless_tpu_torch.core import merkle
    from boundless_tpu_torch.core import poseidon2 as P2

    tree = merkle.commit(x)
    leaves = P2.hash_rows(x)
    want = [leaves] + P2.hash_tree(leaves)
    if len(tree.levels) != len(want):
        raise AssertionError(f"{what}: {len(tree.levels)} levels, plain "
                             f"{len(want)}")
    for d, (got, ref) in enumerate(zip(tree.levels, want)):
        check(got, ref, f"{what} level {d}")
    return len(want)


def phase_kernel_sponge(dev, sm_clocks_per_s, lat):
    """Every layout and the tree top against the plain sponge; times at the
    paths' shapes; a whole commit. (The sweeps that chose the crossovers
    and the tree top's size are `tools/sponge_variants.py --sweep`.)"""
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED)
    check = Checker()
    ns = sorted(set(SPONGE_CHECK_N) | {f + d for f, _ in P2K.LANE_CROSSOVER
                                       for d in (-1, 0, 1)})
    for c in SPONGE_CHECK_C:
        # rows are independent: the plain hash of the first n rows of one
        # matrix is the first n rows of its plain hash
        if c == "init":
            x = rand_words(rng, (ns[-1], P2.WIDTH), dev)
            want = P2.permute(x)
        else:
            x = rand_words(rng, (ns[-1], c), dev)
            want = P2.hash_rows(x)
        for n in ns:
            for lanes in P2K.LANES:
                got = permute_lanes(x[:n], lanes) if c == "init" else \
                    hash_lanes(x[:n], lanes)
                check(got, want[:n], f"lanes={lanes} N={n} C={c}")
        del x, want, got
    for c in SPONGE_CHAIN_C:  # from an initial state, input columns
        x = rand_words(rng, (SPONGE_CHAIN_N[-1], c), dev)
        init = rand_words(rng, (SPONGE_CHAIN_N[-1], P2.WIDTH), dev)
        want = P2.hash_rows(x, init=init, out_words=P2.WIDTH)
        for n in SPONGE_CHAIN_N:
            for lanes in P2K.LANES:
                check(P2K._sponge(x[:n], init[:n], P2.WIDTH, lanes), want[:n],
                      f"chained lanes={lanes} N={n} C={c}")
        check(P2K.hash_rows(x, init), want[:, :P2.DIGEST_WORDS],
              f"chained hash_rows N={SPONGE_CHAIN_N[-1]} C={c}, 8 words")
        del x, init, want
    for n, c in MAIN_PATH_SHAPES:  # the default layout at the path's shapes
        x = rand_words(rng, (n, c), dev)
        check(P2K.hash_rows(x), P2.hash_rows(x), f"hash_rows N={n} C={c}")
    left = rand_words(rng, (1 << 17, 8), dev)
    right = rand_words(rng, (1 << 17, 8), dev)
    want = P2.hash_pair(left, right)
    for lanes in P2K.LANES:
        check(hash_lanes(torch.cat([left, right], 1), lanes), want,
              f"hash_pairs N=2^17 lanes={lanes}")
    tree_sizes = [1 << k for k in range(1, P2K.tree_max().bit_length())]
    for m in tree_sizes:
        level = rand_words(rng, (m, P2.DIGEST_WORDS), dev)
        got, want = P2K.hash_tree(level), P2.hash_tree(level)
        if len(got) != len(want):
            raise AssertionError(f"tree top m={m}: {len(got)} levels")
        for d, (g, w) in enumerate(zip(got, want)):
            check(g, w, f"tree top m={m} level {d + 1}")
    leaf = rand_words(rng, LEAF_SHAPE, dev)
    levels = check_commit(leaf, check, f"merkle.commit {LEAF_SHAPE}")
    say("kernel", kernel="poseidon2_sponge", layouts=",".join(
        f"lanes{g}" for g in P2K.LANES), rows=",".join(map(str, ns)),
        columns=",".join(map(str, SPONGE_CHECK_C)),
        chained_rows=",".join(map(str, SPONGE_CHAIN_N)),
        chained_columns=",".join(map(str, SPONGE_CHAIN_C)),
        tree_top_nodes=f"{tree_sizes[0]}..{tree_sizes[-1]}",
        commit_levels_checked=levels, checked=check.checked, tolerance=0,
        max_abs_err=check.max_err)

    stats = {}
    for what, n, c in SPONGE_TIME_SHAPES:
        plain_c = c
        if c:
            x = rand_words(rng, (n, c), dev)
            fns = {g: (lambda g=g: hash_lanes(x, g)) for g in P2K.LANES}
            # the plain version on at most PLAIN_TIMED_COLS columns (a
            # one-row absorb's chain is one plain permutation after another)
            plain_c = min(c, PLAIN_TIMED_COLS)
            plain = lambda: P2.hash_rows(x[:, :plain_c])  # noqa: E731
        else:
            x = rand_words(rng, (n, P2.WIDTH), dev)
            fns = {g: (lambda g=g: permute_lanes(x, g)) for g in P2K.LANES}
            plain = lambda: P2.permute(x)  # noqa: E731
        ms = {g: sponge_ms(fn, n, c) for g, fn in fns.items()}
        plain_ms = once_ms(plain)
        picked = P2K.lanes_for(n)
        bms, by, lat_ms = sponge_bounds(n, c, picked, sm_clocks_per_s, lat)
        say("kernel", kernel="poseidon2_sponge", shape=f"{n}x{c}",
            what=what.replace(" ", "_"),
            permutations_a_row=max(1, -(-c // P2.RATE)),
            **{f"lanes{g}_ms": f"{v:.4f}" for g, v in ms.items()},
            picked=f"lanes{picked}", kernel_ms=f"{ms[picked]:.4f}",
            plain_ms=f"{plain_ms:.4f}", plain_shape=f"{n}x{plain_c}",
            bound_ms=f"{bms:.4f}", bound_by=by,
            latency_bound_ms=f"{lat_ms:.4f}")
        if (n, c) == LEAF_SHAPE:
            stats = dict(max_abs_err=check.max_err, ms=ms[picked],
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         shape=f"{n}x{c}", plain_shape=f"{n}x{c}")
        del x

    # a tp shard's leaf hash: from the zero state or from the state of the
    # shard before, 8 or all 24 words out
    n, c = SPONGE_CHAIN_TIMED
    x = rand_words(rng, (n, c), dev)
    init = rand_words(rng, (n, P2.WIDTH), dev)
    chain_ms = {f"{'init' if i is not None else 'zero'}_out{w}_ms":
                sponge_ms(lambda i=i, w=w: P2K.hash_rows(x, i, w), n, c)
                for i, w in ((None, P2.DIGEST_WORDS), (None, P2.WIDTH),
                             (init, P2.WIDTH), (init, P2.DIGEST_WORDS))}
    bms, by, lat_ms = sponge_bounds(n, c, P2K.lanes_for(n), sm_clocks_per_s,
                                    lat)
    say("kernel", kernel="poseidon2_sponge", what="tp_shard_leaves",
        shape=f"{n}x{c}", picked=f"lanes{P2K.lanes_for(n)}",
        **{k: f"{v:.4f}" for k, v in chain_ms.items()},
        bound_ms=f"{bms:.4f}", bound_by=by, latency_bound_ms=f"{lat_ms:.4f}")
    del x, init

    # a whole commit of the main path's data group, and its parts
    from boundless_tpu_torch.core import merkle

    leaves = P2K.hash_rows(leaf)
    tops = [leaves]
    while tops[-1].shape[0] > P2K.TREE_TOP:
        tops.append(P2K.hash_rows(tops[-1].view(-1, 2 * P2.DIGEST_WORDS)))

    def levels_above():
        cur = leaves
        while cur.shape[0] > P2K.TREE_TOP:
            cur = P2K.hash_rows(cur.view(-1, 2 * P2.DIGEST_WORDS))

    def pair_bound(hashes: int):  # `hashes` 2-to-1 hashes, 16 words in
        return bound_ms(4 * hashes * (2 + 1) * P2.DIGEST_WORDS,
                        hashes * P2_MULS, hashes * (P2_ADDS + 16),
                        sm_clocks_per_s)

    def levels_above_plain():
        cur = leaves
        while cur.shape[0] > P2K.TREE_TOP:
            cur = P2.hash_rows(cur.view(-1, 2 * P2.DIGEST_WORDS))

    P2K.LAUNCHES = 0
    merkle.commit(leaf)
    levels_bms, levels_by = pair_bound(sum(t.shape[0] for t in tops[1:]))
    top_bms, top_by = pair_bound(tops[-1].shape[0] - 1)
    say("kernel", kernel="poseidon2_sponge",
        commit=f"{LEAF_SHAPE[0]}x{LEAF_SHAPE[1]}", launches=P2K.LAUNCHES,
        commit_ms=f"{cuda_ms(lambda: merkle.commit(leaf), 5):.4f}",
        leaves_ms=f"{cuda_ms(lambda: P2K.hash_rows(leaf), 5):.4f}",
        levels_to_tree_top_ms=f"{device_ms(levels_above, 10):.4f}",
        level_launches=len(tops) - 1,
        levels_to_tree_top_plain_ms=f"{once_ms(levels_above_plain):.4f}",
        levels_bound_ms=f"{levels_bms:.6g}", levels_bound_by=levels_by,
        tree_top_ms=f"{device_ms(lambda: P2K.hash_tree(tops[-1]), 20):.4f}",
        tree_top_plain_ms=f"{once_ms(lambda: P2.hash_tree(tops[-1])):.4f}",
        tree_top_levels=tops[-1].shape[0].bit_length() - 1,
        tree_top_bound_ms=f"{top_bms:.6g}", tree_top_bound_by=top_by)
    return stats


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call, each call closed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_kernel_ntt(dev, sm_clocks_per_s):
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.kernels import ntt as NK

    rng = np.random.default_rng(SEED + 1)
    check = Checker()
    for m in NTT_SUB_M:
        for lanes in NTT_SUB_L:
            x = rand_words(rng, (m, lanes), dev)
            for fw in (True, False):
                check(NK.sub_ntt(x, fw), NTT.stockham(x, fw),
                      f"sub_ntt M={m} L={lanes} forward={fw}")
            n2 = 7 if lanes % 7 == 0 else (32 if lanes % 32 == 0 else 1)
            mid = rand_words(rng, (m, n2), dev)
            check(NK.sub_ntt(x, True, mid), NK.sub_ntt_plain(x, True, mid),
                  f"sub_ntt M={m} L={lanes} four-step store")
    for n, c, fw in NTT_MAIN_SHAPES:
        x = rand_words(rng, (n, c), dev)
        check(NTT.ntt(x, fw), NTT.stockham(x, fw),
              f"four-step N={n} C={c} forward={fw}")
    glue = {"intt": (NTT.intt, NTT.intt_plain),
            "coset_evaluate": (NTT.coset_evaluate, NTT.coset_evaluate_plain),
            "coset_interpolate": (NTT.coset_interpolate,
                                  NTT.coset_interpolate_plain)}
    for name, n, c, expand in NTT_GLUE_SHAPES:
        x = rand_words(rng, (n, c), dev)
        fused, plain = glue[name]
        args = () if name == "intt" else (expand,)
        check(fused(x, *args), plain(x, *args),
              f"{name} N={n} C={c} expand={expand}")

    n, c = NTT_TIME_SHAPE
    x = rand_words(rng, NTT_TIME_SHAPE, dev)
    before = NK.LAUNCHES
    NTT.ntt(x)
    per_call = NK.LAUNCHES - before
    ms = cuda_ms(lambda: NTT.ntt(x), 10)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 2)
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    nbytes = 2 * 4 * n * c  # the input read once, the output written once
    bms, by = bound_ms(nbytes, butterflies, 2 * butterflies, sm_clocks_per_s)
    floor = per_call * nbytes / HBM_BYTES_PER_S * 1e3  # each launch's pass
    # each launch of the four-step alone: the first with the mid twiddle
    # and the transposed store, the second a plain sub-transform
    n1, n2 = NTT._split(n)
    first = x.reshape(n1, n2 * c)
    mid = NTT._mid_twiddles(n1, n2, True, dev)
    first_ms = cuda_ms(lambda: NK.sub_ntt(first, True, mid), 10)
    second = NK.sub_ntt(first, True, mid)
    second_ms = cuda_ms(lambda: NK.sub_ntt(second, True), 10)
    coeffs = rand_words(rng, (n // INV_RATE_GRID, c), dev)
    lde_ms = cuda_ms(lambda: NTT.coset_evaluate(coeffs), 10)
    lde_plain_ms = cuda_ms(lambda: NTT.coset_evaluate_plain(coeffs), 2)
    say("kernel", kernel="ntt_sub_transform", checked=check.checked,
        tolerance=0, max_abs_err=check.max_err, shape=f"{n}x{c}",
        launches_per_transform=per_call, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by, floor_ms_two_launches=f"{floor:.4f}",
        launch_ms=f"{n1}x{n2 * c}+mid:{first_ms:.4f},{n2}x{n1 * c}:"
                  f"{second_ms:.4f}",
        lde_shape=f"{n // INV_RATE_GRID}x{c}->{n}", lde_ms=f"{lde_ms:.4f}",
        lde_plain_ms=f"{lde_plain_ms:.4f}")
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, shape=f"{n}x{c}",
                plain_shape=f"{n}x{c}")


def bbmm_bound_ms(m: int, k: int, w: int, sm_clocks_per_s: float):
    """Bound of an (M, K) x (K, W) weighted sum: the values and weights
    read once and the output written once (4 bytes a word) against M K W
    32x32->64 products, each one FMA-pipe issue (an IMAD.WIDE.U32 that
    adds into its sum, as the constraint kernel's combine counts it; the
    adds of the folds and the final reductions are not counted)."""
    nbytes = 4 * (m * k + k * w + m * w)
    return bound_ms(nbytes, 0, 0, sm_clocks_per_s, extra=(m * k * w, 0, 0))


def bbmm_case(rng, m, k, w, full, dev):
    """Values (M, K) and (K, W) weights: random words, or every word
    P - 1 when `full`."""
    from boundless_tpu_torch.core import field as F

    shape = (m, k)
    if full:
        v = torch.full(shape, F.P - 1, dtype=torch.int32, device=dev)
        wt = torch.full((k, w), F.P - 1, dtype=torch.int32, device=dev)
    else:
        v, wt = rand_words(rng, shape, dev), rand_words(rng, (k, w), dev)
    return v, wt


def int_mm_limbs_ms(m: int, k: int, w: int, dev) -> float:
    """For scale only (never on the path): ms of the reference's method on
    this card's int8 tensor cores, the (5 M, K) x (K, 5 W) int8 limb
    product through torch._int_mm (K and 5 W padded to multiples of 8),
    without the limb split and the fold."""
    kp, np_ = -(-k // 8) * 8, -(-5 * w // 8) * 8
    a = torch.randint(0, 128, (5 * m, kp), dtype=torch.int8, device=dev)
    b = torch.randint(0, 128, (kp, np_), dtype=torch.int8, device=dev)
    return cuda_ms(lambda: torch._int_mm(a, b), 5)


def bbmm_variants():
    """tools/bbmm_variants.py: the weighted sum's first design, built and
    run only to time the kernel against it in [bbmm]."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bbmm_variants

    return bbmm_variants


def bbmm_blocks(rng, m, layout, dev):
    """Random column blocks of `layout` ((width, row stride), ...): a row
    stride 0 is one broadcast row, a stride past the width a column
    slice of a wider matrix."""
    blocks = []
    for width, ld in layout:
        if ld == 0:
            blocks.append(rand_words(rng, (1, width), dev))
        else:
            blocks.append(rand_words(rng, (m, ld), dev)[:, :width])
    return blocks


def in_turns(kernel, first, reps: int):
    """device_ms of `kernel` and `first` in turns (kernel, first, first,
    kernel) -> (the kernel's two times, the first's two)."""
    k1, f1 = device_ms(kernel, reps), device_ms(first, reps)
    f2, k2 = device_ms(first, reps), device_ms(kernel, reps)
    return (k1, k2), (f1, f2)


def phase_kernel_bbmm(dev, sm_clocks_per_s):
    """The weighted sum against its plain version at BBMM_SHAPES and
    BBMM_BLOCK_SHAPES, word for word, with each call's launches; timed in
    turns with its first design at BBMM_TIMED, and at the block shapes of
    a path beside the parent's route (torch.cat, then the first design);
    bb_weighted_sum_t refuses the (K, M) matrix of BBMM_TRANSPOSED_REFUSED
    on the card."""
    from boundless_tpu_torch.core import bbmm as B
    from boundless_tpu_torch.kernels import bbmm as BK

    first_design = bbmm_variants().rows_weighted_sum
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED + 7)
    check = Checker()
    stats = None

    def checked(what, m, k, w, kernel, plain):
        before = BK.LAUNCHES
        got = kernel()
        want = BK.launches_of(m, k, sms)
        if BK.LAUNCHES != before + want:
            raise AssertionError(f"[bbmm] {what}: {BK.LAUNCHES - before} "
                                 f"launches, expected {want}")
        check(got, plain(), f"bb_weighted_sum {what} {m}x{k}x{w}")
        return got

    def reps_of(m, k):
        return max(5, min(50, (1 << 26) // (m * k)))

    for what, path, m, k, w in BBMM_SHAPES:
        v, wt = bbmm_case(rng, m, k, w, what.startswith("max"), dev)
        kernel = lambda v=v, wt=wt: B.bb_weighted_sum(v, wt)  # noqa: E731
        plain = lambda v=v, wt=wt: B.bb_weighted_sum_plain(v, wt)  # noqa: E731
        got = checked(what, m, k, w, kernel, plain)
        fields = dict(slices=BK.plan(m, k, sms)[1])
        if what in BBMM_TIMED:
            first = lambda v=v, wt=wt: first_design(v, wt)  # noqa: E731
            check(first(), got, f"first design {what} {m}x{k}x{w}")
            (k1, k2), (f1, f2) = in_turns(kernel, first, reps_of(m, k))
            ms, first_ms = (k1 + k2) / 2, (f1 + f2) / 2
            plain_ms = cuda_ms(plain, 1)
            bms, by = bbmm_bound_ms(m, k, w, sm_clocks_per_s)
            fields.update(kernel_ms=f"{ms:.4f}", kernel_ms_turns=f"{k1:.4f},"
                          f"{k2:.4f}", first_design_ms=f"{first_ms:.4f}",
                          first_design_ms_turns=f"{f1:.4f},{f2:.4f}",
                          no_slower=ms <= first_ms, plain_ms=f"{plain_ms:.4f}",
                          bound_ms=f"{bms:.4f}", bound_by=by,
                          kernel_over_bound=f"{ms / bms:.2f}",
                          first_over_bound=f"{first_ms / bms:.2f}")
            if what in ("main DEEP z+zg", "lift alpha 4N"):
                fields["int_mm_limbs_ms"] = f"{int_mm_limbs_ms(m, k, w, dev):.4f}"
            if stats is None:  # the main path's largest call
                stats = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, shape=f"{m}x{k}x{w}",
                             plain_shape=f"{m}x{k}x{w}",
                             first_design_ms=first_ms)
        say("bbmm", shape=what, path=path or "-", m=m, k=k, w=w,
            tolerance=0, equal="yes", **fields)
        del v, wt, got
    for what, path, m, layout, w in BBMM_BLOCK_SHAPES:
        blocks = bbmm_blocks(rng, m, layout, dev)
        k = sum(width for width, _ in layout)
        wt = rand_words(rng, (k, w), dev)
        kernel = lambda b=blocks, wt=wt: B.bb_weighted_sum_blocks(b, wt)  # noqa: E731
        plain = lambda b=blocks, wt=wt: B.bb_weighted_sum_blocks_plain(b, wt)  # noqa: E731
        got = checked(what, m, k, w, kernel, plain)
        fields = dict(blocks=len(layout), slices=BK.plan(m, k, sms)[1])
        if path is not None:
            def joined(b=blocks, wt=wt):  # the parent's route
                return first_design(torch.cat(
                    [x.expand(m, x.shape[1]) for x in b], 1), wt)
            check(joined(), got, f"joined first design {what}")
            (k1, k2), (f1, f2) = in_turns(kernel, joined, reps_of(m, k))
            bms, by = bbmm_bound_ms(m, k, w, sm_clocks_per_s)
            fields.update(kernel_ms=f"{(k1 + k2) / 2:.4f}",
                          kernel_ms_turns=f"{k1:.4f},{k2:.4f}",
                          plain_ms=f"{once_ms(plain):.4f}",
                          cat_then_first_design_ms=f"{(f1 + f2) / 2:.4f}",
                          bound_ms=f"{bms:.4f}", bound_by=by,
                          kernel_over_bound=f"{(k1 + k2) / 2 / bms:.2f}")
        say("bbmm", shape=what, path=path or "-", m=m, k=k, w=w,
            tolerance=0, equal="yes", **fields)
        del blocks, wt, got
    k, m, w = BBMM_TRANSPOSED_REFUSED
    rows = torch.empty((k, m), dtype=torch.int32, device=dev)
    before = BK.LAUNCHES, B.PLAIN_ON_CUDA
    try:
        B.bb_weighted_sum_t(rows, rand_words(rng, (k, w), dev))
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("[bbmm] bb_weighted_sum_t ran on the card")
    if (BK.LAUNCHES, B.PLAIN_ON_CUDA) != before:
        raise AssertionError("[bbmm] the refused transposed call launched")
    say("bbmm", shape="combine_rows rv32i (K, M)", k=k, m=m, w=w,
        refused=json.dumps(refusal))
    del rows
    say("bbmm", checked=check.checked, max_abs_err=check.max_err,
        plain_calls_on_cuda_in_checks=B.PLAIN_ON_CUDA)
    stats["max_abs_err"] = check.max_err
    return stats, B.PLAIN_ON_CUDA


# The trace upload's shapes on the main path: rows, the host's row pitch,
# the columns uploaded
UPLOAD_SHAPES = ((1 << 20, 584, 392),  # the po2-20 witness's rv32i columns
                 (1 << 20, 584, 584),  # an rv32im po2-20 witness, whole
                 (1 << 20, 64, 64),  # a rec_po2-20 data trace, contiguous
                 (1 << 17, 584, 392))  # the po2-17 segment's witness
UPLOAD_TURNS = 3  # walls of the port's upload at each shape


def upload_kernel_ms(fn) -> tuple:
    """(device ms of the `upload_kernel` launches, of the host-to-device
    copies, launches) in one call of `fn`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = copy = 0
    launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if "upload_kernel" in e.name():
            kern += e.duration_ns()
            launches += 1
        elif "HtoD" in e.name():
            copy += e.duration_ns()
    return kern / 1e6, copy / 1e6, launches


def phase_upload(dev):
    """The trace upload at each of the main path's shapes (UPLOAD_SHAPES:
    the po2-20 witness's 392 of 584 int64 columns read in place, an rv32im
    witness's 584 whole, a recursion data trace's contiguous 64, the po2-17
    witness): the port's route (`field.upload` -> csrc/upload.cu) word for
    word against `field.fp`, one launch a staging block; UPLOAD_TURNS walls
    of it; the
    kernel's device time (torch.profiler) beside its bytes bound (int64
    read, int32 written, at HBM_BYTES_PER_S); the host route's wall (`fp`:
    numpy's conversion, then a pageable copy); the staging's blocks and
    bytes. One line a shape. Runs in no benchmark cell."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.kernels import upload as UK

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    stats = None
    for k, (rows, pitch, cols) in enumerate(UPLOAD_SHAPES):
        rng = np.random.default_rng(SEED + 18 + k)
        t0 = time.perf_counter()
        data = rng.integers(0, 1 << 31, size=(rows, pitch), dtype=np.int64)
        data[0, :4] = [-1, -F.P, np.iinfo(np.int64).min,
                       np.iinfo(np.int64).max]
        words = data[:, :cols]
        gen_s = time.perf_counter() - t0
        want, host_s = walled(lambda: F.fp(words, dev))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = UK.LAUNCHES
        got, first_s = walled(lambda: F.upload(words, dev))
        staged = torch.cuda.max_memory_allocated() - base - got.numel() * 4
        launches = UK.LAUNCHES - before
        n = UK.block_rows(cols)
        if launches != -(-rows // n) or not torch.equal(got, want):
            raise AssertionError(f"[upload] at {rows} x {cols} of {pitch} "
                                 f"the card's words differ from fp's or "
                                 f"{launches} launches")
        del got, want
        walls = [walled(lambda: F.upload(words, dev))[1]
                 for _ in range(UPLOAD_TURNS)]
        kern_ms, copy_ms, kern_launches = upload_kernel_ms(
            lambda: F.upload(words, dev))
        read_b, write_b = rows * cols * 8, rows * cols * 4
        bound = (read_b + write_b) / HBM_BYTES_PER_S * 1e3
        say("upload", rows=rows, pitch=pitch, cols=cols, tolerance=0,
            equal="yes", block_rows=n, launches=launches,
            staging_bytes=staged, generate_s=f"{gen_s:.3f}",
            host_route_s=f"{host_s:.4f}", first_call_s=f"{first_s:.4f}",
            port_s=",".join(f"{x:.4f}" for x in walls),
            copy_bytes=read_b, kernel_ms=f"{kern_ms:.4f}",
            kernel_launches_profiled=kern_launches, bound_ms=f"{bound:.4f}",
            bound_by="bytes", kernel_over_bound=f"{kern_ms / bound:.2f}",
            htod_device_ms=f"{copy_ms:.4f}")
        if stats is None:  # the witness's shape stands for the kernel
            stats = {"max_abs_err": 0, "kernel_ms": round(kern_ms, 4),
                     "bound_ms": round(bound, 4)}
        del data, words
    return stats


class RecordBbmm:
    """Records (M, K, W) and the column-block table of every weighted-sum
    launch while active into BBMM_SEEN[path] and BBMM_TABLES_SEEN[path]."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        from boundless_tpu_torch.kernels import bbmm as BK

        seen = BBMM_SEEN.setdefault(self.path, set())
        tables = BBMM_TABLES_SEEN.setdefault(self.path, set())
        self._bk, self._orig = BK, BK.weighted_sum_blocks

        def weighted_sum_blocks(blocks, weights):
            blocks = list(blocks)
            m, table = BK.block_table(blocks)
            w = weights.shape[1]
            seen.add((m, sum(x for _, _, x in table), w))
            tables.add((m, tuple((x, ld) for _, ld, x in table), w))
            return self._orig(blocks, weights)

        BK.weighted_sum_blocks = weighted_sum_blocks
        return self

    def __exit__(self, *exc):
        self._bk.weighted_sum_blocks = self._orig


def check_bbmm_paths(plain_checks: int):
    """Every BBMM_SHAPES shape and BBMM_BLOCK_SHAPES table of a path was a
    call of that path, and the plain version ran on the card only in the
    checks: `plain_checks` in [bbmm], and PLAIN_IN_CONS_CHECKS in the
    constraint kernel's plain version."""
    from boundless_tpu_torch.core import bbmm as B

    plain_checks += PLAIN_IN_CONS_CHECKS
    for what, path, m, k, w in BBMM_SHAPES:
        if path is not None and (m, k, w) not in BBMM_SEEN.get(path, ()):
            raise AssertionError(f"[bbmm] {what} {(m, k, w)} is not a call "
                                 f"of [{path}]: {sorted(BBMM_SEEN.get(path, ()))}")
    for what, path, m, layout, w in BBMM_BLOCK_SHAPES:
        seen = BBMM_TABLES_SEEN.get(path, ())
        if path is not None and (m, layout, w) not in seen:
            raise AssertionError(f"[bbmm] {what} {(m, layout, w)} is not a "
                                 f"call of [{path}]: {sorted(seen)}")
    if B.PLAIN_ON_CUDA != plain_checks:
        raise AssertionError(f"[bbmm] the plain version ran "
                             f"{B.PLAIN_ON_CUDA - plain_checks} times on the "
                             f"card outside the checks")
    say("bbmm", path_shapes="all seen on their paths",
        shapes_seen=json.dumps({p: len(v) for p, v in BBMM_SEEN.items()}
                               ).replace(" ", ""),
        tables_seen=json.dumps({p: len(v) for p, v in
                                BBMM_TABLES_SEEN.items()}).replace(" ", ""),
        plain_on_cuda_in_cons_checks=PLAIN_IN_CONS_CHECKS,
        plain_on_cuda_outside_checks=B.PLAIN_ON_CUDA - plain_checks)


class CaptureCons:
    """Records the inputs of every constraint-kernel call while active."""

    def __enter__(self):
        from boundless_tpu_torch.kernels import cons as CK

        self.calls, self._ck, self._orig = [], CK, CK.evaluate_combined

        def evaluate_combined(air, *args):
            self.calls.append((air, args))
            return self._orig(air, *args)

        CK.evaluate_combined = evaluate_combined
        return self

    def __exit__(self, *exc):
        self._ck.evaluate_combined = self._orig


class ForbidCombineRows:
    """Counts calls of the eager α-combine (`cons_eval.combine_rows`) while
    active: the card's route must not make any."""

    def __enter__(self):
        from boundless_tpu_torch.air import cons_eval as CE

        self.calls, self._ce, self._orig = 0, CE, CE.combine_rows

        def combine_rows(*args, **kwargs):
            self.calls += 1
            return self._orig(*args, **kwargs)

        CE.combine_rows = combine_rows
        return self

    def __exit__(self, *exc):
        self._ce.combine_rows = self._orig


class PlainBbmm:
    """While active, the weighted sums (`core/bbmm`) run their plain
    version, which the eager constraints (the LogUp groups) and
    `combine_rows` call: the constraint kernel's plain version launches
    no kernel, or this raises. Adds the plain calls it saw on the card to
    PLAIN_IN_CONS_CHECKS. Used only with no worker threads running."""

    def __enter__(self):
        from boundless_tpu_torch.core import bbmm as B
        from boundless_tpu_torch.kernels import bbmm as BK

        self._b, self._bk = B, BK
        self._orig = (B.bb_weighted_sum, B.bb_weighted_sum_t,
                      B.bb_weighted_sum_blocks)
        self._start = B.PLAIN_ON_CUDA, BK.LAUNCHES
        B.bb_weighted_sum = B.bb_weighted_sum_plain
        B.bb_weighted_sum_t = B.bb_weighted_sum_t_plain
        B.bb_weighted_sum_blocks = B.bb_weighted_sum_blocks_plain
        return self

    def __exit__(self, *exc):
        global PLAIN_IN_CONS_CHECKS
        B, BK = self._b, self._bk
        (B.bb_weighted_sum, B.bb_weighted_sum_t,
         B.bb_weighted_sum_blocks) = self._orig
        PLAIN_IN_CONS_CHECKS += B.PLAIN_ON_CUDA - self._start[0]
        if exc[0] is None and BK.LAUNCHES != self._start[1]:
            raise AssertionError("the constraint kernel's plain version "
                                 "launched the weighted-sum kernel")


def plain_combined(air, args):
    """The fused kernel's plain version: combine_rows of the plain rows,
    every weighted sum in them the plain one (no kernel on the reference)."""
    from boundless_tpu_torch.air import cons_eval as CE
    from boundless_tpu_torch.kernels import cons as CK

    *grid, alpha, masks = args
    with PlainBbmm():
        return CE.combine_rows(CE.trace(air).kinds,
                               CK.evaluate_plain(air, *grid), alpha, masks)


def check_cons(calls, check, what):
    from boundless_tpu_torch.kernels import cons as CK

    for air, args in calls:
        got = CK.evaluate_combined(air, *args)
        want = plain_combined(air, args)
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} class columns, plain "
                                 f"{len(want)}")
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, f"constraint columns {air.name} {what} "
                  f"M={args[1].shape[0]} class {k}")


def counts():
    from boundless_tpu_torch.kernels import bbmm as BK
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.kernels import upload as UK

    return {"poseidon2_sponge": P2K.LAUNCHES, "ntt_sub_transform": NK.LAUNCHES,
            "cons_eval": CK.LAUNCHES, "bb_weighted_sum": BK.LAUNCHES,
            "trace_upload": UK.LAUNCHES}


def all_counts():
    """Launches of all six kernels (`counts()` and the wrap's two)."""
    from boundless_tpu_torch.kernels import msm as MK
    from boundless_tpu_torch.kernels import poseidon254 as P254K

    return {**counts(), "p254_sponge": P254K.LAUNCHES,
            "bn254_msm": MK.LAUNCHES}


def zero_counts():
    from boundless_tpu_torch.kernels import bbmm as BK
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import msm as MK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.kernels import poseidon254 as P254K
    from boundless_tpu_torch.kernels import upload as UK

    P2K.LAUNCHES = NK.LAUNCHES = CK.LAUNCHES = BK.LAUNCHES = 0
    P254K.LAUNCHES = MK.LAUNCHES = UK.LAUNCHES = 0
    for table in (P2K.LAUNCHES_BY_LAYOUT, P254K.LAUNCHES_BY_LAYOUT):
        for layout in table:
            table[layout] = 0


SPONGE_KINDS = ("leaves", "tree_levels", "tree_top", "permute", "absorb",
                "verifier", "other")


class SpongeProfile:
    """The device time of every sponge launch while active, summed by kind:
    `leaves` (the first launch of a merkle.commit), `tree_levels` (its
    launches of one level each), `tree_top` (its hash_tree launch),
    `permute` (Transcript._permute), `absorb` (the hash of
    Transcript.mix_elems), `verifier` (merkle.verify_rows), else `other`;
    `kind` labels every launch. Also the launches by layout.

    Each launch is timed by CUDA events around it, behind a spin kernel of
    SPIN_CLOCKS (~0.1 ms) queued first: the card is then still busy when
    the host queues the events and the launch, so the events time the
    kernel and not the card's wait for the host (a proof is host-bound).
    The spins add device time to the profiled run, not to the sums. Works
    on a tree whose wrapper launches through `_sponge` (and `hash_tree`
    where it has one).

    With sponge="p254" it times the p254 sponge's launches instead
    (`kernels/poseidon254._launch`, by its layout): `leaves`,
    `tree_levels` and `tree_top` of a `Poseidon254Suite.commit`,
    `verifier` of its `verify_rows`."""

    SPIN_CLOCKS = 200_000

    def __init__(self, kind=None, sponge="poseidon2"):
        self.kind = kind
        self.sponge = sponge
        self.records = []  # (kind, layout, start event, end event)

    def _kind_now(self):
        if self.kind is not None:
            return self.kind
        if not self._spans:
            return "other"
        span = self._spans[-1]
        if span[0] != "commit":
            return span[0]
        span[1] += 1
        return "leaves" if span[1] == 1 else "tree_levels"

    def __enter__(self):
        from boundless_tpu_torch.core import merkle, suites, transcript
        from boundless_tpu_torch.kernels import poseidon2 as P2K
        from boundless_tpu_torch.kernels import poseidon254 as P254K

        self._spans, self._patched = [], []
        spin = spin_lib()

        def patch(owner, name, wrap):
            orig = getattr(owner, name)
            setattr(owner, name, wrap(orig))
            self._patched.append((owner, name, orig))

        def spanned(kind):
            def wrap(orig):
                def call(*args, **kwargs):
                    self._spans.append([kind, 0])
                    try:
                        return orig(*args, **kwargs)
                    finally:
                        self._spans.pop()
                return call
            return wrap

        def timed(layout_of):
            def wrap(orig):
                def call(*args, **kwargs):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    rc = spin.bt_spin(self.SPIN_CLOCKS,
                                      torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"spin launch failed: CUDA error "
                                           f"{rc}")
                    start.record()
                    out = orig(*args, **kwargs)
                    end.record()
                    layout = layout_of(args, kwargs)
                    kind = self._kind_now()
                    if layout == "tree_top" and kind == "tree_levels":
                        kind = "tree_top"
                    self.records.append((kind, layout, start, end))
                    return out
                return call
            return wrap

        def sponge_layout(args, kwargs):
            lanes = args[3] if len(args) > 3 else kwargs.get("lanes")
            if lanes is None:
                lanes = P2K.lanes_for(args[0].shape[0]) \
                    if hasattr(P2K, "lanes_for") else 1
            return f"lanes{lanes}"

        if self.sponge == "p254":
            patch(suites.Poseidon254Suite, "commit", spanned("commit"))
            patch(suites.Poseidon254Suite, "verify_rows",
                  spanned("verifier"))
            patch(P254K, "_launch", timed(
                lambda args, kwargs: args[2] if len(args) > 2 else "lanes1"))
            return self
        patch(merkle, "commit", spanned("commit"))
        patch(merkle, "verify_rows", spanned("verifier"))
        patch(transcript.Transcript, "_permute", spanned("permute"))
        patch(transcript.Transcript, "mix_elems", spanned("absorb"))
        patch(P2K, "_sponge", timed(sponge_layout))
        if hasattr(P2K, "hash_tree"):
            patch(P2K, "hash_tree", timed(lambda args, kwargs: "tree_top"))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._patched):
            setattr(owner, name, orig)

    def summary(self) -> dict:
        """{"<kind>_ms", "<kind>_launches", "total_ms", "layouts"}."""
        torch.cuda.synchronize()
        out = {f"{k}_{x}": 0 for k in SPONGE_KINDS for x in ("launches",
                                                              "ms")}
        layouts = {}
        for kind, layout, start, end in self.records:
            out[f"{kind}_launches"] += 1
            out[f"{kind}_ms"] += start.elapsed_time(end)
            layouts[layout] = layouts.get(layout, 0) + 1
        out["total_ms"] = sum(out[f"{k}_ms"] for k in SPONGE_KINDS)
        out["layouts"] = layouts
        return out


def profile_sponge(phase: str, what: str, make, kind=None,
                   sponge="poseidon2"):
    """The sponge's device time by kind in one more run of `make` (a warm
    proof or verifier), apart from the timed and counted runs, whose walls
    must not hold SpongeProfile's spins and events."""
    with SpongeProfile(kind, sponge) as prof:
        out = make()
    say(phase, stage=what, profiled="a separate warm run",
        **sponge_fields(prof.summary()))
    return out


def check_layouts(what: str):
    """A proof runs the transcript at 8 lanes a hash and every commit's
    tree top in one launch: both counts must be > 0."""
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    seen = P2K.LAUNCHES_BY_LAYOUT
    if seen[f"lanes{P2K.LANES[-1]}"] <= 0 or seen["tree_top"] <= 0:
        raise AssertionError(f"{what}: a sponge layout did not run: {seen}")


def layouts_now() -> str:
    """The sponge's launches by layout since the counts were zeroed."""
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    return json.dumps(P2K.LAUNCHES_BY_LAYOUT).replace(" ", "")


def sponge_fields(summary: dict) -> dict:
    """A SpongeProfile summary as `say` fields."""
    fields = {f"sponge_{k}": (f"{v:.4f}" if k.endswith("_ms") else v)
              for k, v in summary.items() if k != "layouts" and v}
    fields["sponge_layouts"] = json.dumps(summary["layouts"]).replace(
        " ", "")
    return fields


def phase_golden(dev, cons_check):
    from boundless_tpu_torch import convert as C
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.zkvm import prove

    g = np.load(os.path.join(ROOT, "tests", "data", "torch_golden_po2_8.npz"))
    zero_counts()
    with CaptureCons() as cap:
        for variant in ("rv32im", "rv32i"):
            pre = variant + "/"
            data = F.fp(g[pre + "in.data"].astype(np.int64), dev)
            ctrl = F.fp(g[pre + "in.ctrl"].astype(np.int64), dev)
            pub = C.pub_from_numpy(
                {k[len(pre + "in.pub."):]: g[k] for k in g.files
                 if k.startswith(pre + "in.pub.")}, dev)
            gold = {k[len(pre + "proof."):]: g[k] for k in g.files
                    if k.startswith(pre + "proof.")}
            t0 = time.perf_counter()
            proof = stark.prove(prove._AIRS[variant], data, pub, 8,
                                prove.TEST_PS, ctrl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if proof.data_root.device.type != "cuda":
                raise AssertionError("golden proof did not run on the card")
            flat = C.proof_to_numpy(proof)
            if sorted(flat) != sorted(gold):
                raise AssertionError(f"{variant}: proof fields differ from "
                                     f"golden")
            bad = [k for k in gold if not np.array_equal(flat[k], gold[k])]
            if bad:
                raise AssertionError(f"{variant}: words differ from golden: "
                                     f"{bad}")
            say("golden", variant=variant, po2=8, arrays=len(gold),
                equal="bit-for-bit", prove_s=f"{secs:.3f}")
    launched = counts()
    del launched["trace_upload"]  # the golden traces go up through fp
    if min(launched.values()) <= 0:
        raise AssertionError(f"a kernel was not launched in the golden "
                             f"proofs: {launched}")
    check_cons(cap.calls, cons_check, "golden po2 8")
    say("golden", launches=json.dumps(launched).replace(" ", ""),
        constraint_grids_checked=len(cap.calls),
        class_columns=[len(args[-1]) for _, args in cap.calls], tolerance=0,
        max_abs_err=cons_check.max_err)


def phase_main(dev, cons_check, sm_clocks_per_s):
    from boundless_tpu_torch.air import cons_eval as CE
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.zkvm import guests, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    image = guests.loop_guest()
    iters = ((1 << MAIN_PO2) - 40) // 2
    torch.cuda.reset_peak_memory_stats()
    native_before = prove.NATIVE_WITNESSES
    with CaptureCons() as cap, ForbidCombineRows() as eager, \
            KeepResults(prove, "_gen_witness") as witnesses, \
            RecordBbmm("main"):
        zero_counts()
        t0 = time.perf_counter()
        res = Executor(image, guests.words([iters]),
                       segment_po2=MAIN_PO2).run()
        seg = res.segments[0]
        t_exec = time.perf_counter() - t0
        variant = prove.air_variant_of(image, seg)
        if variant != "rv32i":
            raise AssertionError(f"loop guest picked {variant}, "
                                 f"expected rv32i")
        t0 = time.perf_counter()
        receipt = prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        launches = counts()  # the main path's own: executor + witness + prove
        layouts = dict(P2K.LAUNCHES_BY_LAYOUT)
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"prove_segment skipped a kernel: {launches}")
    if eager.calls:
        raise AssertionError(f"the card's proof ran the eager α-combine "
                             f"combine_rows {eager.calls} times")
    if prove.NATIVE_WITNESSES != native_before + 1:
        raise AssertionError("the witness did not come from the native C++ "
                             "generator")
    if min(layouts[f"lanes{g}"] for g in (1, 2, 8)) <= 0 or \
            layouts["tree_top"] <= 0:
        raise AssertionError(f"the proof skipped a sponge layout: {layouts}")
    P2K.LAUNCHES = 0
    t0 = time.perf_counter()
    with RecordBbmm("verify"):
        ok = prove.verify_segment(receipt, prove.DEFAULT_PS)
    t_verify = time.perf_counter() - t0
    verify_launches = P2K.LAUNCHES
    if not ok:
        raise AssertionError("verify_segment rejected the po2-17 proof")
    if verify_launches <= 0:
        raise AssertionError("verify_segment launched no sponge kernel")
    if receipt.proof.data_root.device.type != "cuda":
        raise AssertionError("the main-path proof did not run on the card")
    io = receipt.pub["io"].copy()
    io[0, 2] ^= 1
    tampered = dataclasses.replace(receipt, pub={**receipt.pub, "io": io})
    if prove.verify_segment(tampered, prove.DEFAULT_PS):
        raise AssertionError("verify_segment accepted a tampered io word")
    say("main", guest="loop", po2=MAIN_PO2, variant=variant,
        queries=prove.DEFAULT_PS.queries, cycles=seg.cycles,
        exec_s=f"{t_exec:.3f}", prove_s=f"{t_prove:.3f}",
        verify_s=f"{t_verify:.3f}",
        proved_mcycles_per_s=f"{seg.cycles / t_prove / 1e6:.6f}",
        max_memory_allocated=peak, witness="native",
        launches=json.dumps(launches).replace(" ", ""),
        verify_sponge_launches=verify_launches, tampered="rejected",
        eager_combine_rows_calls=eager.calls)
    say("main", sponge_by_layout=json.dumps(layouts).replace(" ", ""))
    again = profile_sponge("main", "proof", lambda: prove.prove_segment(
        image, seg, prove.DEFAULT_PS, device=dev))
    profile_sponge("main", "verify", lambda: prove.verify_segment(
        again, prove.DEFAULT_PS), kind="verifier")

    # The constraint kernel on the proof's own 4N grid.
    if len(cap.calls) != 1:
        raise AssertionError(f"{len(cap.calls)} constraint-kernel calls in "
                             f"the proof, expected 1")
    check_cons(cap.calls, cons_check, f"main po2 {MAIN_PO2}")
    air, args = cap.calls[0]
    ctrl, data, accum, globals_, pub, alpha, masks = args
    prog = CE.trace(air)
    pubvec = air.cons_pub_pack(pub, globals_)
    weights = CE.alpha_weight_rows(prog.kinds, alpha)
    sels = CK.selectors(prog, masks)
    ms = cuda_ms(lambda: CK.launch(air, ctrl, data, accum, pubvec, weights,
                                   sels), 5)
    wrapper_ms = cuda_ms(lambda: CK.evaluate_combined(air, *args), 3)
    pack_ms = cuda_ms(lambda: air.cons_pub_pack(pub, globals_), 3)
    weights_ms = cuda_ms(lambda: CE.alpha_weight_rows(prog.kinds, alpha), 3)
    plain_ms = cuda_ms(lambda: plain_combined(air, args), 1)
    m = data.shape[0]
    muls, adds = CK.field_ops(prog)
    comb = CK.combine_counts(prog)
    # the combine as the kernel does it: one IMAD.WIDE a product, a fold is
    # an IMAD.WIDE and a move, a final reduction a Montgomery product
    extra = tuple(m * (comb["products"] * p + comb["folds"] * f
                       + comb["reductions"] * r)
                  for p, f, r in zip((1, 0, 0), (1, 0, 1), MUL_MIX))
    nbytes = 4 * m * (sum(prog.cols) + 4 * len(sels))
    bms, by = bound_ms(nbytes, m * muls, m * adds, sm_clocks_per_s, extra)
    say("kernel", kernel="cons_eval", variant=air.name, grid_rows=m,
        rows=len(prog.outputs), chunks=len(CK.chunks(prog)),
        class_columns=len(sels), products_per_row=muls, adds_per_row=adds,
        combine_products_per_row=comb["products"],
        combine_folds_per_row=comb["folds"], checked=cons_check.checked,
        tolerance=0, max_abs_err=cons_check.max_err, kernel_ms=f"{ms:.4f}",
        wrapper_ms_with_public_pack=f"{wrapper_ms:.4f}",
        public_pack_ms=f"{pack_ms:.4f}", weights_ms=f"{weights_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
        blocks_per_sm=CK.blocks_per_sm(air), warps_per_block=CK.WARPS)
    grid = f"{m}-row grid, {air.name}"
    cons = dict(max_abs_err=cons_check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, shape=grid, plain_shape=grid)
    return launches, cons, witnesses.results[0]


# [wide]: an rv32im segment of po2 20, whose data LDE (2^22 x 584) is past
# 2^31 words. The guest reads n, then runs a mul/mulhu/divu/remu chain n
# times: 9 cycles an iteration, 20 fixed.
WIDE_PO2 = 20
# risc0's proof system, as the seg20-rv32im cell proves: 50 queries, rate 1/4
WIDE_PS_ARGS = dict(queries=50, fri_min_degree=256, commit_expand=4)
WIDE_FILL = 0.95  # of the segment's cycles
WIDE_SAMPLES = 48  # sampled columns or rows a check, beside the last few
CHAIN_SRC = """
start:
    li t0, 2
    ecall
    mv s2, a0
    li s3, 0
    li s4, 0x9e3779b9
    li s5, 12345
chain:
    beq s3, s2, done
    mul s5, s5, s4
    mulhu t1, s5, s4
    divu t3, s5, t1
    remu t4, s5, t1
    add s5, s5, t3
    xor s5, s5, t4
    addi s3, s3, 1
    j chain
done:
    mv a0, s5
    li t0, 1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""


class KeepWidestBbmm:
    """Keeps the arguments of the weighted-sum call of the most values
    (rows x columns) while active."""

    def __enter__(self):
        from boundless_tpu_torch.kernels import bbmm as BK

        self.call, self._words = None, -1
        self._bk, self._orig = BK, BK.weighted_sum_blocks

        def weighted_sum_blocks(blocks, weights):
            blocks = list(blocks)
            m = max(b.shape[0] for b in blocks)
            words = m * sum(b.shape[1] for b in blocks)
            if words > self._words:
                self.call, self._words = (blocks, weights), words
            return self._orig(blocks, weights)

        BK.weighted_sum_blocks = weighted_sum_blocks
        return self

    def __exit__(self, *exc):
        self._bk.weighted_sum_blocks = self._orig


def sampled(n: int, seed: int) -> torch.Tensor:
    """WIDE_SAMPLES indices below n, drawn, with 0, 1 and the last three."""
    rng = np.random.default_rng(seed)
    picked = {0, 1, n - 1, n - 2, n - 3} | {
        int(i) for i in rng.choice(n, WIDE_SAMPLES, replace=False)}
    return torch.tensor(sorted(picked))


def phase_wide(dev):
    """An rv32im segment of po2 20 through prove_segment, then each kernel
    at the shapes its proof gives it against its plain route on sampled
    columns or rows (see the module's docstring). Returns the proof's
    launches by kernel."""
    from boundless_tpu_torch.core import bbmm as B
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import bbmm as BK
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.kernels import upload as UK
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.zkvm import guests, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def same(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"[wide] {what}: the kernel's words differ "
                                 f"from the plain route's")

    image = guests.build(CHAIN_SRC)
    iters = (int(WIDE_FILL * (1 << WIDE_PO2)) - 20) // 9
    t0 = time.perf_counter()
    res = Executor(image, guests.words([iters]), segment_po2=WIDE_PO2).run()
    t_exec = time.perf_counter() - t0
    if len(res.segments) != 1:
        raise AssertionError(f"[wide] {len(res.segments)} segments, "
                             f"expected 1")
    seg = res.segments[0]
    variant = prove.air_variant_of(image, seg)
    if variant != "rv32im":
        raise AssertionError(f"[wide] the chain guest picked {variant}")
    ps = stark.ProofSystem(**WIDE_PS_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CaptureCons() as cap, KeepWidestBbmm() as widest:
        zero_counts()
        t0 = time.perf_counter()
        receipt = prove.prove_segment(image, seg, ps, device=dev)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        launches = counts()
        layouts = dict(P2K.LAUNCHES_BY_LAYOUT)
    peak = torch.cuda.max_memory_allocated()
    air, args = cap.calls[0] if len(cap.calls) == 1 else (None, None)
    if air is None or air.name != "rv32im":
        raise AssertionError(f"[wide] {len(cap.calls)} constraint-kernel "
                             f"calls, expected one of the rv32im AIR")
    uploads = -(-(1 << WIDE_PO2) // UK.block_rows(air.data_cols))
    if min(launches.values()) <= 0 or launches["trace_upload"] != uploads:
        raise AssertionError(f"[wide] the proof's launches {launches}, "
                             f"{uploads} uploads expected")
    if not prove.verify_segment(receipt, ps):
        raise AssertionError("[wide] verify_segment rejected the proof")
    io = receipt.pub["io"].copy()
    io[0, 2] ^= 1
    tampered = dataclasses.replace(receipt, pub={**receipt.pub, "io": io})
    if prove.verify_segment(tampered, ps):
        raise AssertionError("[wide] verify_segment accepted a tampered io "
                             "word")
    ctrl, data, accum = args[:3]
    m, cols = data.shape
    say("wide", guest="chain", po2=WIDE_PO2, variant=variant,
        queries=ps.queries, commit_expand=ps.commit_expand, cycles=seg.cycles,
        exec_s=f"{t_exec:.3f}", prove_s=f"{t_prove:.3f}",
        max_memory_allocated=peak, lde_words=m * cols,
        launches=json.dumps(launches).replace(" ", ""),
        sponge_by_layout=json.dumps(layouts).replace(" ", ""),
        verify="accepted", tampered="rejected")
    del receipt, tampered, cap

    # the constraint kernel on the proof's own grid; a sampled row r reads
    # row r + INV_RATE (mod m), so the plain route runs on the rows r .. r
    # + 2 INV_RATE - 1 of each sample, side by side
    before = CK.LAUNCHES
    got, ms = timed(lambda: CK.evaluate_combined(air, *args))
    rows = sampled(m, 1)
    span = 2 * INV_RATE_GRID
    grid = ((rows[:, None] + torch.arange(span)) % m).reshape(-1).to(dev)
    want, plain_ms = timed(lambda: plain_combined(
        air, tuple(x[grid].contiguous() for x in args[:3]) + tuple(args[3:])))
    for k, (g, w) in enumerate(zip(got, want)):
        same(g[rows.to(dev)], w[::span], f"constraint class {k}")
    say("wide", kernel="cons_eval", variant=air.name, grid=f"{m}x{cols}",
        ctrl_cols=ctrl.shape[1], accum_cols=accum.shape[1],
        sampled_rows=len(rows), tolerance=0, equal="yes",
        launches=CK.LAUNCHES - before, wrapper_ms=f"{ms:.4f}",
        plain_ms_sampled=f"{plain_ms:.4f}", plain_rows=len(grid))
    del got, want, grid

    # the NTT: the grid's data as the four-step's leading (1024, .) tile
    x = data.view(NK.MAX_M, -1)
    before = NK.LAUNCHES
    y, ms = timed(lambda: NK.sub_ntt(x, True))
    picked = sampled(x.shape[1], 2).to(dev)
    want, plain_ms = timed(lambda: NK.sub_ntt_plain(
        x[:, picked].contiguous(), True))
    same(y[:, picked], want, f"sub-transform {tuple(x.shape)}")
    say("wide", kernel="ntt_sub_transform", tile=f"{x.shape[0]}x{x.shape[1]}",
        words=x.numel(), sampled_cols=len(picked), tolerance=0, equal="yes",
        launches=NK.LAUNCHES - before, kernel_ms=f"{ms:.4f}",
        plain_ms_sampled=f"{plain_ms:.4f}")
    del y
    coeffs = data[: 1 << WIDE_PO2]
    before = NK.LAUNCHES
    evals, ms = timed(lambda: NTT.coset_evaluate(coeffs, expand=4))
    if NK.LAUNCHES - before != 3 or tuple(evals.shape) != (m, cols):
        raise AssertionError(f"[wide] coset LDE: {NK.LAUNCHES - before} "
                             f"launches, shape {tuple(evals.shape)}")
    picked = sampled(cols, 3).to(dev)
    want, plain_ms = timed(lambda: NTT.coset_evaluate_plain(
        coeffs[:, picked].contiguous(), 4))
    same(evals[:, picked], want, f"coset LDE of {tuple(coeffs.shape)}")
    back, back_ms = timed(lambda: NTT.coset_interpolate(evals, expand=4))
    same(back, coeffs, "coset interpolation of the LDE")
    say("wide", kernel="ntt_sub_transform", four_step=f"{coeffs.shape[0]}x"
        f"{cols}->{m}x{cols}", sampled_cols=len(picked), tolerance=0,
        equal="yes", back="equal", launches=3, lde_ms=f"{ms:.4f}",
        interpolate_ms=f"{back_ms:.4f}", plain_ms_sampled=f"{plain_ms:.4f}")
    del evals, back
    torch.cuda.empty_cache()

    # the sponge's leaves of the grid's data rows
    before = P2K.LAUNCHES_BY_LAYOUT["lanes1"]
    leaves, ms = timed(lambda: P2K.hash_rows(data))
    rows = sampled(m, 4)
    picked = data[rows.to(dev)]
    want, plain_ms = timed(lambda: P2.hash_rows(picked))
    same(leaves[rows.to(dev)], want, f"sponge leaves of {m}x{cols}")
    say("wide", kernel="poseidon2_sponge", leaves=f"{m}x{cols}",
        layout="lanes1", sampled_rows=len(rows), tolerance=0, equal="yes",
        launches=P2K.LAUNCHES_BY_LAYOUT["lanes1"] - before,
        kernel_ms=f"{ms:.4f}", plain_ms_sampled=f"{plain_ms:.4f}")
    del leaves, picked

    # the proof's widest weighted sum, as it was called (the plain route
    # on the host: the card's plain calls are counted apart)
    blocks, weights = widest.call
    mw = max(b.shape[0] for b in blocks)
    k = sum(b.shape[1] for b in blocks)
    before = BK.LAUNCHES
    got, ms = timed(lambda: B.bb_weighted_sum_blocks(blocks, weights))
    rows = sampled(mw, 5)
    want = B.bb_weighted_sum_blocks_plain(
        [(b[rows.to(b.device)] if b.shape[0] == mw else b).cpu()
         for b in blocks], weights.cpu())
    same(got[rows.to(dev)].cpu(), want, f"weighted sum {mw}x{k}")
    say("wide", kernel="bb_weighted_sum", values=f"{mw}x{k}",
        w=weights.shape[1], blocks=len(blocks), words=mw * k,
        sampled_rows=len(rows), tolerance=0, equal="yes",
        launches=BK.LAUNCHES - before, kernel_ms=f"{ms:.4f}")
    del got, blocks, weights, widest, args, ctrl, data, accum, x, coeffs
    torch.cuda.empty_cache()
    return launches


class KeepResults:
    """The return values of every call of `module.name` while active."""

    def __init__(self, module, name):
        self.module, self.name, self.results = module, name, []

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def kept(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            self.results.append(out)
            return out

        setattr(self.module, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


class TimeCalls:
    """Host seconds of every call of `module.name` while active, each
    closed by a device synchronize."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


class Stages:
    """Host seconds of the recursion proofs made while active, from the
    port's tracer (`utils/profiling.py`, on while active): `seconds` maps
    `witness`, `native_eval` and `prove` to the sums of the spans
    `rec.witness`, `rec.native_eval` and `rec.prove`, and `proof` to the
    sum of the proofs' own spans (`rec.lift`, `rec.join`, `rec.shrink`,
    ...). The stages' spans wait for the card before they close."""

    STAGES = ("witness", "native_eval", "prove")

    def __enter__(self):
        from boundless_tpu_torch.utils import profiling

        self._tracer = profiling
        profiling.enable()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._tracer.disable()
        self.seconds = dict.fromkeys(self.STAGES + ("proof",), 0.0)
        for r in self._tracer.records():
            if r["t0_ns"] < self._t0 or not r["name"].startswith("rec."):
                continue
            stage = r["name"][len("rec."):]
            key = stage if stage in self.STAGES else "proof"
            self.seconds[key] += (r["t1_ns"] - r["t0_ns"]) / 1e9


def phase_recursion_kernels(dev, sm_clocks_per_s, lat):
    """The sponge and the NTT at the recursion proofs' largest shapes."""
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED + 2)
    check = Checker()
    x = rand_words(rng, REC_SPONGE_SHAPE, dev)
    want = P2.hash_rows(x)
    for lanes in P2K.LANES:
        check(hash_lanes(x, lanes), want, f"rec leaves lanes={lanes}")
    del want
    levels = check_commit(x, check, f"merkle.commit {REC_SPONGE_SHAPE}")
    n, c = REC_SPONGE_SHAPE
    ms = {g: cuda_ms(lambda g=g: hash_lanes(x, g), 5) for g in P2K.LANES}
    plain_ms = cuda_ms(lambda: P2.hash_rows(x), 1)
    picked = P2K.lanes_for(n)
    bms, by, lat_ms = sponge_bounds(n, c, picked, sm_clocks_per_s, lat)
    say("kernel", kernel="poseidon2_sponge", path="recursion",
        shape=f"{n}x{c}", commit_levels_checked=levels, tolerance=0,
        max_abs_err=check.max_err,
        **{f"lanes{g}_ms": f"{v:.4f}" for g, v in ms.items()},
        picked=f"lanes{picked}", kernel_ms=f"{ms[picked]:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
        latency_bound_ms=f"{lat_ms:.4f}")
    del x
    x = rand_words(rng, REC_NTT_SHAPE, dev)
    before = NK.LAUNCHES
    got = NTT.ntt(x)
    per_call = NK.LAUNCHES - before
    if per_call != 3:
        raise AssertionError(f"the 2^22 NTT made {per_call} launches, not 3")
    check(got, NTT.stockham(x), "four-step rec 4N evaluate")
    del got
    ms = cuda_ms(lambda: NTT.ntt(x), 5)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 1)
    n, c = REC_NTT_SHAPE
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    bms, by = bound_ms(2 * 4 * n * c, butterflies, 2 * butterflies,
                       sm_clocks_per_s)
    say("kernel", kernel="ntt_sub_transform", path="recursion",
        shape=f"{n}x{c}", launches_per_transform=per_call, tolerance=0,
        max_abs_err=check.max_err, kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)


def rom_sha256(prog) -> str:
    """sha256 of a program's ROM words (canonical little-endian u32)."""
    import hashlib

    return hashlib.sha256(prog.ctrl_trace_np().astype("<u4").tobytes()
                          ).hexdigest()


def check_control_id(got, gold, key: str):
    """A program's control ID (8 canonical words) against the JAX golden."""
    want = tuple(int(x) for x in gold[f"{key}/control_id"])
    if tuple(int(x) for x in got) != want:
        raise AssertionError(f"{key}: control ID {tuple(got)} differs from "
                             f"JAX's {want}")


def phase_recursion(dev):
    """Two po2-17 segment proofs lifted into rec_po2-20 RecursionAir
    proofs, joined, finalized and verified, all on the card."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import succinct, vm
    from boundless_tpu_torch.zkvm import guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    seg_ps = prove.DEFAULT_PS
    image = guests.loop_guest()
    iters = ((1 << MAIN_PO2) - 40) // 2  # the main path's session: 2 segments
    t0 = time.perf_counter()
    ex = Executor(image, guests.words([iters]), segment_po2=MAIN_PO2)
    res = ex.run()
    t_exec = time.perf_counter() - t0
    if len(res.segments) != 2:
        raise AssertionError(f"{len(res.segments)} segments, expected 2")
    seg_receipts = []
    for seg in res.segments:
        zero_counts()
        t0 = time.perf_counter()
        r = prove.prove_segment(image, seg, seg_ps, device=dev)
        torch.cuda.synchronize()
        launches = counts()
        if min(launches.values()) <= 0:
            raise AssertionError(f"segment proof skipped a kernel: {launches}")
        say("recursion", stage="segment_proof", segment=seg.index,
            cycles=seg.cycles, variant=r.variant,
            prove_s=f"{time.perf_counter() - t0:.3f}",
            launches=json.dumps(launches).replace(" ", ""))
        seg_receipts.append(r)
    t0 = time.perf_counter()
    chains = succinct.segment_pre_chains(ex, res)
    t_chains = time.perf_counter() - t0

    params = succinct.SuccinctParams(
        seg_po2=MAIN_PO2, seg_ps=seg_ps, rec_po2=REC_PO2,
        rec_ps=stark.ProofSystem(**REC_PS_ARGS), variants=("rv32i",))
    system = succinct.SuccinctSystem(params, device=dev)
    gold = np.load(REC_GOLDEN)
    ctrl_gold = np.load(CONTROL_GOLDEN)
    for kind, prog in system.progs.items():
        if rom_sha256(prog) != str(gold[f"prod/{kind}/rom_sha256"]):
            raise AssertionError(f"{kind} ROM differs from the JAX digest")
        check_control_id(system.control_ids[kind], ctrl_gold,
                         f"rec20/{kind}")
        say("recursion", stage="rom", program=kind,
            rows=int(gold[f"prod/{kind}/rows"]), rom="equal to JAX sha256",
            control_id=",".join(str(x) for x in system.control_ids[kind]),
            control_id_vs_jax="equal")
    say("recursion", stage="setup", exec_s=f"{t_exec:.3f}",
        segment_pre_chains_s=f"{t_chains:.4f}",
        program_build_s=f"{system.seconds['program_build']:.3f}",
        control_ids_s=f"{system.seconds['control_ids']:.3f}",
        allowed_root=",".join(str(x) for x in system.allowed_root))

    evals_before = vm.NATIVE_EVALS
    rec_launches = {k: 0 for k in counts()}

    def recursion_proof(what, make):
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with TimeCalls(stark, "_quotient_coeffs") as quotient, \
                Stages() as stages:
            t0 = time.perf_counter()
            r = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        if launches["poseidon2_sponge"] <= 0 or \
                launches["ntt_sub_transform"] <= 0:
            raise AssertionError(f"{what}: a kernel was not launched: "
                                 f"{launches}")
        if launches["cons_eval"] != 0:
            raise AssertionError(f"{what}: RecursionAir ran the constraint "
                                 f"kernel")
        check_layouts(what)
        if r.proof.data_root.device != dev:
            raise AssertionError(f"{what}: the proof did not run on the card")
        for k, v in launches.items():
            rec_launches[k] += v
        sec = stages.seconds
        say("recursion", stage=what, wall_s=f"{wall:.3f}",
            proof_s=f"{sec['proof']:.3f}",
            witness_s=f"{sec['witness']:.3f}",
            native_eval_s=f"{sec['native_eval']:.3f}",
            prove_s=f"{sec['prove']:.3f}",
            quotient_s=f"{sum(quotient.seconds):.3f}",
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=json.dumps(launches).replace(" ", ""),
            sponge_by_layout=layouts_now())
        return r

    with RecordBbmm("recursion"):
        lifts = [recursion_proof(f"lift{seg.index}", lambda sr=sr, seg=seg:
                                 system.lift(sr, chains[seg.index],
                                             seg.pre_mem, seg.index))
                 for sr, seg in zip(seg_receipts, res.segments)]
    joined = recursion_proof("join", lambda: system.join(*lifts))
    native = vm.NATIVE_EVALS - evals_before
    if native != 3:
        raise AssertionError(f"{native} native rec_eval runs for 3 proofs")
    seg = res.segments[-1]
    profile_sponge("recursion", f"lift{seg.index}", lambda: system.lift(
        seg_receipts[-1], chains[seg.index], seg.pre_mem, seg.index))

    words = [int(w) for w in ex.journal_words]
    session = succinct.finalize_session(joined, words, image.entry,
                                        paging.image_root(image))
    t0 = time.perf_counter()
    ok = succinct.verify_session(session, system)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("verify_session rejected the session receipt")
    for r in lifts + [joined]:
        if not system.verify(r):
            raise AssertionError(f"verify rejected a {r.kind} receipt")
    fc = joined.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    bumped = dataclasses.replace(joined, proof=joined.proof._replace(
        fri_proof=joined.proof.fri_proof._replace(final_coeffs=fc)))
    if system.verify(bumped):
        raise AssertionError("verify accepted a join proof with a bumped word")
    moved = dataclasses.replace(joined, claim=dataclasses.replace(
        joined.claim, post_pc=joined.claim.post_pc + 4))
    if system.verify(moved):
        raise AssertionError("verify accepted a claim with post_pc changed")
    say("recursion", stage="session", segments=len(lifts),
        cycles=res.total_cycles, halted=joined.claim.halted,
        verify_session_s=f"{t_verify:.3f}", verify_session="accepted",
        receipts_verified=len(lifts) + 1, bumped_proof="rejected",
        changed_post_pc="rejected", native_rec_evals=native,
        launches_recursion=json.dumps(rec_launches).replace(" ", ""))
    return rec_launches, system, session


def phase_coproc_kernels(dev, sm_clocks_per_s, lat):
    """The sponge and the NTT at the KeccakAir proof's shapes (4048 data
    columns: 126 whole 32-column NTT strips and a 16-column tail; 253
    rate blocks a leaf)."""
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED + 3)
    check = Checker()
    x = rand_words(rng, KEC_SPONGE_SHAPE, dev)
    check(P2K.hash_rows(x), P2.hash_rows(x), "hash_rows keccak leaves")
    n, c = KEC_SPONGE_SHAPE
    ms = cuda_ms(lambda: P2K.hash_rows(x), 5)
    plain_ms = cuda_ms(lambda: P2.hash_rows(x), 1)
    picked = P2K.lanes_for(n)
    bms, by, lat_ms = sponge_bounds(n, c, picked, sm_clocks_per_s, lat)
    say("coproc", kernel="poseidon2_sponge", shape=f"{n}x{c}", tolerance=0,
        max_abs_err=check.max_err, picked=f"lanes{picked}",
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by, latency_bound_ms=f"{lat_ms:.4f}")
    glue = (("intt", NTT.intt, NTT.intt_plain, ()),
            ("coset_evaluate", NTT.coset_evaluate, NTT.coset_evaluate_plain,
             (INV_RATE_GRID,)))
    for name, fused, plain, args in glue:
        x = rand_words(rng, KEC_TRACE_SHAPE, dev)
        check(fused(x, *args), plain(x, *args),
              f"{name} keccak {KEC_TRACE_SHAPE}")
    x = rand_words(rng, KEC_NTT_SHAPE, dev)
    check(NTT.ntt(x), NTT.stockham(x), "ntt keccak forward")
    ms = cuda_ms(lambda: NTT.ntt(x), 5)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 1)
    n, c = KEC_NTT_SHAPE
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    bms, by = bound_ms(2 * 4 * n * c, butterflies, 2 * butterflies,
                       sm_clocks_per_s)
    say("coproc", kernel="ntt_sub_transform", shape=f"{n}x{c}",
        glue_checked=",".join(g[0] for g in glue), tolerance=0,
        max_abs_err=check.max_err, checked=check.checked,
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by)


def phase_coproc(dev, cons_check):
    """The keccak coprocessor on the card: a keccak guest's po2-17 rv32im
    segment and its KeccakAir batch lifted into rec_po2-21 proofs, the
    coproc chain discharged by resolve_coproc, the session finalized and
    verified; then two chained random batches (42 + 17 permutations)
    lifted and united."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import air as rair
    from boundless_tpu_torch.recursion import coproc_succinct as cs
    from boundless_tpu_torch.recursion import succinct, vm
    from boundless_tpu_torch.zkvm import coproc, guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    gold = np.load(KEC_GOLDEN)
    q50 = stark.ProofSystem(**REC_PS_ARGS)
    cparams = cs.CoprocParams(kec_po2=KEC_PO2, kec_ps=q50,
                              rec_po2=COPROC_REC_PO2, rec_ps=q50)
    params = succinct.SuccinctParams(
        seg_po2=MAIN_PO2, seg_ps=prove.DEFAULT_PS, rec_po2=COPROC_REC_PO2,
        rec_ps=q50, variants=("rv32im",))
    coproc_launches = {k: 0 for k in counts()}

    def counted(what, make, stages: bool = False,
                cons_kernel: bool = False):
        """Run one proof with the launch counts zeroed just before and read
        right after: sponge and NTT launched, the constraint kernel
        launched iff `cons_kernel` (the rv32im segment proof). `stages`:
        a recursion proof, whose stages the tracer times."""
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with TimeCalls(stark, "_quotient_coeffs") as quotient, \
                Stages() as timed:
            t0 = time.perf_counter()
            r = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        check_layouts(what)
        for k, v in launches.items():
            coproc_launches[k] += v
        if launches["poseidon2_sponge"] <= 0 or \
                launches["ntt_sub_transform"] <= 0:
            raise AssertionError(f"{what}: a kernel was not launched: "
                                 f"{launches}")
        if (launches["cons_eval"] > 0) != cons_kernel:
            raise AssertionError(f"{what}: {launches['cons_eval']} "
                                 f"constraint-kernel launches")
        if r.proof.data_root.device != dev:
            raise AssertionError(f"{what}: the proof did not run on the card")
        sec = {} if not stages else {
            f"{k}_s": f"{timed.seconds[k]:.3f}"
            for k in ("proof",) + Stages.STAGES}
        say("coproc", stage=what, wall_s=f"{wall:.3f}", **sec,
            quotient_s=f"{sum(quotient.seconds):.3f}",
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=json.dumps(launches).replace(" ", ""),
            sponge_by_layout=layouts_now())
        return r

    # the keccak guest's session: one po2-17 segment, one permutation
    image = guests.keccak_guest()
    t0 = time.perf_counter()
    ex = Executor(image, guests.words([]), segment_po2=MAIN_PO2)
    res = ex.run()
    t_exec = time.perf_counter() - t0
    if len(res.segments) != 1 or not ex.keccak_states:
        raise AssertionError(f"keccak guest: {len(res.segments)} segments, "
                             f"{len(ex.keccak_states)} permutations")
    seg = res.segments[0]
    with CaptureCons() as cap:
        seg_receipt = counted("segment_proof", lambda: prove.prove_segment(
            image, seg, prove.DEFAULT_PS, device=dev), cons_kernel=True)
    if seg_receipt.variant != "rv32im":
        raise AssertionError(f"the keccak segment proved {seg_receipt.variant}")
    if not prove.verify_segment(seg_receipt, prove.DEFAULT_PS):
        raise AssertionError("verify_segment rejected the keccak segment")
    check_cons(cap.calls, cons_check, f"coproc rv32im po2 {MAIN_PO2}")
    say("coproc", stage="segment", guest="keccak", cycles=seg.cycles,
        permutations=len(ex.keccak_states), exec_s=f"{t_exec:.3f}",
        verify_segment="accepted", constraint_grids_checked=len(cap.calls),
        tolerance=0, max_abs_err=cons_check.max_err)

    # programs, ROMs and control IDs of both lattices
    placeholder = (tuple(int(x) for x in gold["placeholder/coproc_root"]),
                   tuple(int(x) for x in gold["placeholder/kec_circuit_id"]))
    t0 = time.perf_counter()
    system = succinct.SuccinctSystem(params, coproc=cparams, device=dev)
    t_systems = time.perf_counter() - t0
    csys = system.coproc_sys
    # resolve_coproc embeds the coproc allowed root and the keccak circuit
    # id; its ROM is held to JAX's through a build with the golden's
    # placeholder constants in their place
    t0 = time.perf_counter()
    progs = dict(system.progs, **csys.progs)
    progs["resolve_coproc"] = succinct.build_resolve_coproc(
        COPROC_REC_PO2, q50, placeholder[0], COPROC_REC_PO2, q50,
        placeholder[1]).finalize(1 << COPROC_REC_PO2)
    t_placeholder = time.perf_counter() - t0
    cid = coproc.circuit_id(KEC_PO2, q50, dev)
    if cid != tuple(int(x) for x in gold["prod/circuit_id"]):
        raise AssertionError("the keccak circuit id differs from JAX's")
    ids = dict(system.control_ids, **csys.control_ids)
    # the placeholder build's control ID, as the systems compute theirs
    ids["resolve_coproc"] = tuple(int(x) for x in F.from_mont(
        stark.control_root_of(rair.AIR, COPROC_REC_PO2, rair.rom_trace(
            progs["resolve_coproc"], 1 << COPROC_REC_PO2, dev), q50)))
    ctrl_gold = np.load(CONTROL_GOLDEN)
    for kind, prog in progs.items():
        if rom_sha256(prog) != str(gold[f"prod/{kind}/rom_sha256"]):
            raise AssertionError(f"{kind} ROM differs from the JAX digest")
        check_control_id(ids[kind], ctrl_gold, f"rec21/{kind}")
        say("coproc", stage="rom", program=kind,
            rows=int(gold[f"prod/{kind}/rows"]), rom="equal to JAX sha256",
            built_with=("placeholder constants" if kind == "resolve_coproc"
                        else "the real constants"),
            control_id=",".join(str(x) for x in ids[kind]),
            control_id_vs_jax="equal")
    say("coproc", stage="setup",
        coproc_program_build_s=f"{csys.seconds['program_build']:.3f}",
        coproc_control_ids_s=f"{csys.seconds['control_ids']:.3f}",
        main_program_build_s=f"{system.seconds['program_build']:.3f}",
        main_control_ids_s=f"{system.seconds['control_ids']:.3f}",
        systems_wall_s=f"{t_systems:.3f}",
        placeholder_build_s=f"{t_placeholder:.3f}",
        circuit_id="equal to JAX",
        coproc_allowed_root=",".join(str(x) for x in csys.allowed_root),
        allowed_root=",".join(str(x) for x in system.allowed_root))
    evals_before = vm.NATIVE_EVALS

    # the guest chain: batch -> lift_keccak; segment -> lift; resolve_coproc
    with RecordBbmm("keccak"):
        kec = counted("keccak_proof guest", lambda: coproc.prove_keccak(
            ex.keccak_states, KEC_PO2, q50, device=dev))
    if not coproc.verify_keccak(kec, q50):
        raise AssertionError("verify_keccak rejected the guest's batch")
    bumped_pub = kec.states_pub.copy()
    bumped_pub[0, 1] = (int(bumped_pub[0, 1]) + 1) % F.P
    if coproc.verify_keccak(dataclasses.replace(kec, states_pub=bumped_pub),
                            q50):
        raise AssertionError("verify_keccak accepted a bumped state limb")
    if kec.digests() != list(ex.keccak_claims):
        raise AssertionError("batch digests differ from the ecall claims")
    # the same batch by columns on a (1, 2) mesh that names the card twice
    from boundless_tpu_torch.air import keccak as K
    from boundless_tpu_torch.parallel import mesh as M

    kdata, kpub, _ = K.witness(ex.keccak_states, KEC_PO2)
    kdata = F.fp(kdata, dev)
    kpub = K.PublicValues(states=F.fp(kpub["states"], dev))
    kmesh = M.make_mesh(devices=[dev, dev], dp=1)
    fn, shard_fn = M.shard_batched_prover(K.AIR, KEC_PO2, q50, kmesh)
    tp, t_tp, tp_launches, moved, chained, peaks = mesh_run(
        fn, shard_fn([kdata], [kpub], None), [dev])
    # the single proof again, without the witness, timed the same way
    single, t_single, _, _, _, single_peak = mesh_run(
        lambda: [stark.prove(K.AIR, kdata, kpub, KEC_PO2, q50)], (), [dev])
    del kdata
    for k in coproc_launches:
        coproc_launches[k] += tp_launches[k]
    if not (same_proof(tp[0], kec.proof) and same_proof(single[0],
                                                          kec.proof)):
        raise AssertionError("[coproc] the tp-2 KeccakAir proof differs from "
                             "the single proof")
    if min(tp_launches[k] for k in ("poseidon2_sponge", "ntt_sub_transform",
                                    "bb_weighted_sum")) <= 0:
        raise AssertionError(f"[coproc] the tp-2 KeccakAir proof skipped a "
                             f"kernel: {tp_launches}")
    say("coproc", stage="keccak_proof guest tp2", vs_single="equal",
        data_shards="|".join(str(b - a) for a, b in M.column_split(
            K.AIR.data_cols, 2)), tp_s=f"{t_tp:.3f}",
        single_s=f"{t_single:.3f}", max_memory_allocated=peaks[str(dev)],
        single_max_memory_allocated=single_peak[str(dev)], moved_bytes=moved,
        chained_sponge_launches=len(chained),
        launches=json.dumps(tp_launches).replace(" ", ""))
    klift = counted("lift_keccak guest", lambda: csys.lift(kec), True)
    chains = succinct.segment_pre_chains(ex, res)
    lift = counted("lift", lambda: system.lift(
        seg_receipt, chains[seg.index], seg.pre_mem, seg.index), True)
    words = [int(w) for w in ex.journal_words]
    mem_root = paging.image_root(image)
    try:
        succinct.finalize_session(lift, words, image.entry, mem_root)
        raise AssertionError("finalize_session accepted an undischarged lift")
    except succinct.SuccinctError:
        pass
    resolved = counted("resolve_coproc", lambda: system.resolve_coproc(
        lift, klift), True)
    session = succinct.finalize_session(resolved, words, image.entry,
                                        mem_root)
    t0 = time.perf_counter()
    if not succinct.verify_session(session, system):
        raise AssertionError("verify_session rejected the keccak session")
    t_verify = time.perf_counter() - t0
    for r in (lift, resolved):
        if not system.verify(r):
            raise AssertionError(f"verify rejected a {r.kind} receipt")
    if not csys.verify(klift):
        raise AssertionError("verify rejected the lift_keccak receipt")
    fc = klift.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    if csys.verify(dataclasses.replace(klift, proof=klift.proof._replace(
            fri_proof=klift.proof.fri_proof._replace(final_coeffs=fc)))):
        raise AssertionError("verify accepted a lift_keccak proof with a "
                             "bumped word")
    moved = dataclasses.replace(resolved, claim=dataclasses.replace(
        resolved.claim, post_coproc=lift.claim.post_coproc))
    if system.verify(moved):
        raise AssertionError("verify accepted a resolve_coproc claim with "
                             "post_coproc changed")
    say("coproc", stage="session", guest="keccak",
        post_coproc="discharged", verify_session="accepted",
        verify_session_s=f"{t_verify:.3f}", bumped_state_limb="rejected",
        bumped_lift_keccak_word="rejected",
        changed_post_coproc="rejected", undischarged_finalize="raised")

    # the union of two chained random batches
    rng = np.random.default_rng(SEED + 4)
    batches = [[[int(v) for v in rng.integers(0, 1 << 64, size=25,
                                               dtype=np.uint64)]
                for _ in range(k)] for k in UNION_PERMS]
    lifts, chain, count = [], (0,) * 8, 0
    for i, states in enumerate(batches):
        r = counted(f"keccak_proof batch{i}", lambda s=states:
                    coproc.prove_keccak(s, KEC_PO2, q50, device=dev))
        lifts.append(counted(f"lift_keccak batch{i}",
                             lambda r=r, c=chain, n=count: csys.lift(r, c, n),
                             True))
        chain, count = lifts[-1].claim.post_chain, count + len(states)
    united = counted("union", lambda: csys.union(*lifts), True)
    span = (united.claim.pre_count, united.claim.post_count)
    if not csys.verify(united) or span != (0, sum(UNION_PERMS)):
        raise AssertionError(f"the union did not verify over 0 -> "
                             f"{sum(UNION_PERMS)}: {span}")
    try:
        csys.union(lifts[1], lifts[0])
        raise AssertionError("union accepted its children in the wrong order")
    except ValueError:
        pass
    native = vm.NATIVE_EVALS - evals_before
    if native != 6:
        raise AssertionError(f"{native} native rec_eval runs for 6 proofs")
    again = profile_sponge("coproc", "keccak_proof guest", lambda:
                           coproc.prove_keccak(ex.keccak_states, KEC_PO2, q50,
                                               device=dev))
    profile_sponge("coproc", "lift_keccak guest", lambda: csys.lift(again))
    say("coproc", stage="union", permutations="+".join(map(str, UNION_PERMS)),
        span=f"{span[0]}->{span[1]}", verify="accepted",
        wrong_order="raised", native_rec_evals=native,
        launches_coproc=json.dumps(coproc_launches).replace(" ", ""))
    return coproc_launches, system

# ---------------------------------------------------------------------------
# The proving cluster: sessions submitted over HTTP, proved on the card
# ---------------------------------------------------------------------------

# the loop guest's iterations (3 cycles each) for 1.75 po2-17 segments of
# 130,940 cycles: 2 segments, so 2 prove+lift tasks and one join (cut from
# 4 segments and a two-level join tree to keep the whole script inside the
# time it is allowed)
CLUSTER_ITERS = 7 * 130940 // 12
CLUSTER_SEGMENTS = 2
CLUSTER_POOLS = {"exec": 1, "prove": 2, "join": 1, "aux": 1}
CLUSTER_TIMEOUT_S = 600


def task_seconds() -> dict:
    """{stream: (tasks, seconds)} of the cluster's TASK_DURATION
    histograms (cluster/metrics.REGISTRY)."""
    from boundless_tpu_torch.cluster import metrics as M

    out = {}
    for (name, labels), h in list(M.REGISTRY._metrics.items()):
        if name == M.TASK_DURATION:
            out[dict(labels)["stream"]] = (h._n, h._sum)
    return out


def cluster_session(ctx, pools, name, image, input_words, counted=False):
    """One session through the port's REST API over localhost HTTP
    (ClusterApi + make_http_server + BentoClient, `run_workers` threads):
    upload, create, wait for SUCCEEDED (a FAILED session raises with the
    task's error), download /receipts/stark/<job>. With `counted`, the
    launch counts are zeroed just before the session is created and read
    as it succeeds. Returns (status, wall s, receipt bytes, launches,
    {stream: (tasks, s)}, native rec_evals, native witnesses, peak
    bytes)."""
    from boundless_tpu_torch.cluster.agent import run_workers
    from boundless_tpu_torch.cluster.api import (BentoClient, ClusterApi,
                                                 make_http_server)
    from boundless_tpu_torch.recursion import vm
    from boundless_tpu_torch.zkvm import guests, prove

    api = ClusterApi(ctx)
    server, thread = make_http_server(api)
    thread.start()
    client = BentoClient(f"http://127.0.0.1:{server.server_address[1]}")
    threads, agents = run_workers(ctx, pools)
    try:
        client.upload_image(name, image)
        client.upload_input(f"{name}-in", guests.words(input_words))
        before = task_seconds()
        evals, witnesses = vm.NATIVE_EVALS, prove.NATIVE_WITNESSES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            zero_counts()
        t0 = time.perf_counter()
        job = client.create_session(name, f"{name}-in",
                                    segment_po2=MAIN_PO2)
        st = client.wait(job, timeout=CLUSTER_TIMEOUT_S, poll=0.05)
        wall = time.perf_counter() - t0
        launches = all_counts() if counted else {}
        if st["status"] != "SUCCEEDED":
            raise AssertionError(f"cluster session {name} ended "
                                 f"{st['status']}: {st.get('error_msg')}")
        peak = torch.cuda.max_memory_allocated()
        after = task_seconds()
        streams = {k: (n - before.get(k, (0, 0.0))[0],
                       t - before.get(k, (0, 0.0))[1])
                   for k, (n, t) in after.items()
                   if n > before.get(k, (0, 0.0))[0]}
        data = client._req("GET", f"/receipts/stark/{job}")
        return (st, wall, data, launches, streams, vm.NATIVE_EVALS - evals,
                prove.NATIVE_WITNESSES - witnesses, peak)
    finally:
        for a in agents:
            a.stop()
        for t in threads:
            t.join(timeout=60)
        server.shutdown()
        server.server_close()


def check_cluster_session(dev, root, name, image, words, segments,
                          system, real_kw, pools) -> dict:
    """Session `name` (`segments` segments) through a dev-mode cluster,
    then through the real one on `dev`; holds the real receipt to
    verify_session and to the dev-mode claim digest, journal and stats.
    Returns its launches."""
    import tempfile

    from boundless_tpu_torch.cluster.agent import ClusterContext
    from boundless_tpu_torch.cluster.hotstore import HotStore
    from boundless_tpu_torch.cluster.storage import SharedFs
    from boundless_tpu_torch.cluster.taskdb import MemoryBackend
    from boundless_tpu_torch.recursion import coproc_succinct as cs
    from boundless_tpu_torch.recursion import succinct
    from boundless_tpu_torch.utils import serde
    from boundless_tpu_torch.zkvm import paging, prove

    def context(**kw):
        return ClusterContext(
            db=MemoryBackend(), hot=HotStore(),
            store=SharedFs(tempfile.mkdtemp(dir=root)), ps=prove.DEFAULT_PS,
            segment_po2=MAIN_PO2, device=dev, **kw)

    dev_kw = dict(succinct=succinct.DevModeSystem(), dev_mode=True)
    if "coproc_succinct" in real_kw:
        dev_kw.update(coproc_succinct=cs.DevModeCoprocSystem(),
                      coproc_po2=real_kw["coproc_po2"])
    t0 = time.perf_counter()
    ref_st, _, ref_data, *_ = cluster_session(
        context(**dev_kw), pools, f"dev{name}", image, words)
    t_ref = time.perf_counter() - t0
    ref = serde.load_session_receipt(ref_data, dev)
    st, wall, data, launches, streams, evals, witnesses, peak = \
        cluster_session(context(succinct=system, **real_kw), pools, name,
                        image, words, counted=True)
    if min(launches[k] for k in ("poseidon2_sponge", "ntt_sub_transform",
                                 "cons_eval")) <= 0:
        raise AssertionError(f"session {name} skipped a kernel: {launches}")
    if st["stats"]["segments"] != segments:
        raise AssertionError(f"session {name} ran {st['stats']['segments']} "
                             f"segments, expected {segments}")
    # recursion proofs: a lift a segment and the joins; with the coproc
    # lattice a lift_keccak and a resolve_coproc a batch (one here)
    proofs = 2 * segments - 1 + (2 if "coproc_succinct" in real_kw else 0)
    if evals != proofs or witnesses != segments:
        raise AssertionError(f"session {name}: {evals} rec_evals for "
                             f"{proofs} proofs, {witnesses} witnesses for "
                             f"{segments} segments")
    t0 = time.perf_counter()
    session = serde.load_session_receipt(data, dev)
    t_load = time.perf_counter() - t0
    if session.root.proof.data_root.device != torch.device(dev):
        raise AssertionError("the receipt did not load onto the card")
    t0 = time.perf_counter()
    ok = succinct.verify_session(session, system,
                                 expected_mem_root=paging.image_root(image))
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"verify_session rejected session {name}")
    got = (session.root.claim.digest(), session.journal, st["stats"])
    want = (ref.root.claim.digest(), ref.journal, ref_st["stats"])
    if got != want:
        raise AssertionError(f"session {name}: claim, journal or stats "
                             f"differ from dev mode: {got} vs {want}")
    p = system.params
    say("cluster", session=name, segments=segments,
        cycles=st["stats"]["total_cycles"],
        lattice=f"rec_po2={p.rec_po2}:q{p.rec_ps.queries}:"
                + "+".join(p.variants)
                + (":coproc" if "coproc_succinct" in real_kw else ""),
        wall_s=f"{wall:.3f}", dev_mode_wall_s=f"{t_ref:.3f}",
        receipt_bytes=len(data), load_s=f"{t_load:.3f}",
        verify_session_s=f"{t_verify:.3f}", verify_session="accepted",
        claim_journal_stats_vs_dev_mode="equal",
        exit_code=st["stats"]["exit_code"], native_rec_evals=evals,
        max_memory_allocated=peak,
        launches=json.dumps(launches).replace(" ", ""))
    say("cluster", session=name, task_seconds=json.dumps(
        {k: {"tasks": n, "s": round(t, 3)}
         for k, (n, t) in sorted(streams.items())}).replace(" ", ""))
    return launches


def phase_cluster(dev, rec_system, coproc_system):
    """Two sessions through the port's cluster (REST API over localhost
    HTTP, worker threads, taskdb, planner, hot and object stores), proved
    on the card with the systems [recursion] and [coproc] built: A, the
    loop guest in CLUSTER_SEGMENTS po2-17 segments on the rv32i rec_po2-20
    lattice; B,
    the keccak guest on the coproc lattices at rec_po2 21."""
    import shutil
    import tempfile

    from boundless_tpu_torch.zkvm import guests

    torch.cuda.empty_cache()  # earlier phases' cached blocks
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cluster_store_",
                            dir=os.path.join(ROOT, "build"))
    cluster_launches = {k: 0 for k in all_counts()}
    try:
        a = check_cluster_session(dev, root, "A", guests.loop_guest(),
                                  [CLUSTER_ITERS], CLUSTER_SEGMENTS,
                                  rec_system, {}, CLUSTER_POOLS)
        b = check_cluster_session(
            dev, root, "B", guests.keccak_guest(), [], 1, coproc_system,
            dict(coproc_succinct=coproc_system.coproc_sys,
                 coproc_po2=KEC_PO2), dict(CLUSTER_POOLS, coproc=1))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in cluster_launches:
        cluster_launches[k] = a[k] + b[k]
    say("cluster", launches_cluster=json.dumps(cluster_launches
                                               ).replace(" ", ""))
    return cluster_launches


# ---------------------------------------------------------------------------
# The market: signed requests locked, proved on the card and fulfilled
# ---------------------------------------------------------------------------

# the loop guest's iterations (3 cycles each): MARKET_ITERS is 1.75 po2-17
# segments of 130,940 cycles (2 segments, as CLUSTER_ITERS),
# MARKET_ONE_ITERS half of one segment
MARKET_ITERS = 7 * 130940 // 12
MARKET_SEGMENTS = 2
MARKET_ONE_ITERS = 130940 // 6
MARKET_TIMEOUT_S = 600
SELECTOR_STARK = "0x00000000"  # market/router.py: the session STARK seal


class TimedVerifier:
    """A chain's verifier with each call's request id, verdict and
    seconds kept."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, fill, request):
        t0 = time.perf_counter()
        ok = self.fn(fill, request)
        dt = time.perf_counter() - t0
        with self._lock:
            self.calls.append((fill.request_id.encoded(), ok, dt))
        return ok


def market_world(verifier, provider):
    """A MarketChain with a funded requestor and prover, and the
    requestor's Client."""
    from boundless_tpu_torch.market.chain import MarketChain
    from boundless_tpu_torch.market.client import Client
    from boundless_tpu_torch.market.crypto import Wallet

    chain = MarketChain(verifier)
    alice = Wallet.from_seed(b"alice")
    chain.create_account(alice.address, funds=10**9)
    chain.create_account("prover1", funds=10**7)
    chain.deposit_collateral("prover1", 10**6)
    return chain, Client(chain, alice, storage_provider=provider)


def market_orders(mode, chain, client, prover, provider, iters, segments,
                  **config):
    """One loop-guest order per entry of `iters`, built and submitted to
    `chain` one after the other and fulfilled by a port Broker driving
    `prover` (a ClusterProver); MarketBench records submit -> locked and
    submit -> fulfilled from the chain's events. Every order must end
    FULFILLED with the executor's journal and a seal of `segments`
    segments, and the prover's balance must rise. Returns [(request,
    fill, BenchRow)]."""
    from boundless_tpu_torch.market.bench import MarketBench
    from boundless_tpu_torch.market.broker.pipeline import (Broker,
                                                            BrokerConfig,
                                                            OrderStatus)
    from boundless_tpu_torch.zkvm import guests
    from boundless_tpu_torch.zkvm.executor import fast_execute

    paid = chain.balances["prover1"]
    broker = Broker(chain, prover, "prover1",
                    BrokerConfig(min_mcycle_price=0, **config),
                    storage=provider)
    image = guests.loop_guest()
    broker.start()
    try:
        rows = MarketBench(client, chain, image,
                           lambda i: guests.words([iters[i]]),
                           count=len(iters)).run(timeout=MARKET_TIMEOUT_S)
    finally:
        broker.stop()
    out = []
    for it, row in zip(iters, rows):
        order = broker.orders.get(row.request_id)
        status = order.status if order else None
        if status != OrderStatus.FULFILLED or row.fulfilled_at is None:
            raise AssertionError(
                f"[market] {mode} order {row.request_id} ended {status}: "
                f"{order.error if order else 'never ingested'}")
        fill = chain.get_fulfillment(row.request_id)
        journal = fast_execute(image, guests.words([it]))[2]
        if fill.journal != journal:
            raise AssertionError(f"[market] {mode} journal differs from "
                                 f"the executor's")
        if len(fill.seal.root.segments) != segments:
            raise AssertionError(
                f"[market] {mode} seal of {len(fill.seal.root.segments)} "
                f"segments, expected {segments}")
        row.cycles = order.cycles
        out.append((chain.requests[row.request_id], fill, row))
        say("market", mode=mode, order=row.request_id, status=status,
            segments=segments, cycles=row.cycles,
            submit_to_locked_s=row.lock_latency,
            submit_to_fulfilled_s=row.fulfill_latency,
            effective_khz=row.effective_khz, journal_vs_executor="equal")
    if chain.balances["prover1"] <= paid:
        raise AssertionError(f"[market] {mode}: the prover was not paid")
    say("market", mode=mode, prover_paid=chain.balances["prover1"] - paid)
    return out


def tampered_seal(seal):
    """`seal` with one word of its first segment's public io flipped."""
    seg = seal.root.segments[0]
    pub = dict(seg.pub)
    io = np.array(pub["io"], copy=True)
    io.flat[0] ^= 1
    pub["io"] = io
    segments = [dataclasses.replace(seg, pub=pub)] + list(
        seal.root.segments[1:])
    return dataclasses.replace(
        seal, root=dataclasses.replace(seal.root, segments=segments))


def phase_market(dev, ps=None):
    """Signed requests through the port's market onto its cluster, proved
    on `dev` (ClusterContext: DEFAULT_PS, segment po2 17, succinct=None,
    pools CLUSTER_POOLS): (a) two loop-guest orders of MARKET_SEGMENTS
    segments fulfilled per fill on a chain whose verifier is
    default_router(DEFAULT_PS, dev); (b) two one-segment orders on a
    second chain fulfilled in one batch through the in-guest ECDSA
    assessor and submit_root_and_fulfill; (c) a seal of (a) with one
    flipped public io word rejected on the card."""
    import shutil
    import tempfile

    from boundless_tpu_torch.cluster.agent import ClusterContext, run_workers
    from boundless_tpu_torch.cluster.api import ClusterApi
    from boundless_tpu_torch.cluster.hotstore import HotStore
    from boundless_tpu_torch.cluster.storage import SharedFs
    from boundless_tpu_torch.cluster.taskdb import MemoryBackend
    from boundless_tpu_torch.market import batcher
    from boundless_tpu_torch.market.broker.cluster_prover import \
        ClusterProver
    from boundless_tpu_torch.market.client import LocalStorageProvider
    from boundless_tpu_torch.market.router import default_router
    from boundless_tpu_torch.market.types import Fulfillment
    from boundless_tpu_torch.zkvm import prove
    from boundless_tpu_torch.zkvm.executor import fast_execute

    ps = ps or prove.DEFAULT_PS
    torch.cuda.empty_cache()  # earlier phases' cached blocks
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="market_store_",
                            dir=os.path.join(ROOT, "build"))
    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                         store=SharedFs(os.path.join(root, "cluster")),
                         ps=ps, segment_po2=MAIN_PO2, succinct=None,
                         device=dev)
    provider = LocalStorageProvider(SharedFs(os.path.join(root, "market")))
    router = default_router(ps, dev).market_verifier(SELECTOR_STARK)
    per_fill, batched = TimedVerifier(router), TimedVerifier(router)
    prover = ClusterProver(ClusterApi(ctx), timeout=MARKET_TIMEOUT_S)
    threads, agents = run_workers(ctx, CLUSTER_POOLS)
    try:
        chain_a, client_a = market_world(per_fill, provider)
        chain_b, client_b = market_world(batched, provider)
        before = task_seconds()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        a = market_orders("per_fill", chain_a, client_a, prover, provider,
                          (MARKET_ITERS, MARKET_ITERS + 1), MARKET_SEGMENTS)
        t_a = time.perf_counter() - t0
        b = market_orders("batch", chain_b, client_b, prover, provider,
                          (MARKET_ONE_ITERS, MARKET_ONE_ITERS + 1), 1,
                          batch_fulfill=True, batch_size=2)
        wall = time.perf_counter() - t0
        launches = all_counts()
        peak = torch.cuda.max_memory_allocated()
        after = task_seconds()
    finally:
        for ag in agents:
            ag.stop()
        for t in threads:
            t.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    if min(launches[k] for k in ("poseidon2_sponge", "ntt_sub_transform",
                                 "cons_eval")) <= 0:
        raise AssertionError(f"[market] skipped a kernel: {launches}")
    # (a) each fill's seal was verified once, under the chain's lock, and
    # accepted; the batch's fills met no per-fill verifier
    if sorted(c[0] for c in per_fill.calls) != sorted(
            r.id.encoded() for r, _, _ in a) or not all(
            c[1] for c in per_fill.calls):
        raise AssertionError(f"[market] per-fill verifies: {per_fill.calls}")
    if batched.calls:
        raise AssertionError(f"[market] the batch met the per-fill "
                             f"verifier: {batched.calls}")
    streams = {k: (n - before.get(k, (0, 0.0))[0],
                   t - before.get(k, (0, 0.0))[1])
               for k, (n, t) in after.items()
               if n > before.get(k, (0, 0.0))[0]}
    say("market", orders=len(a) + len(b), wall_s=f"{wall:.3f}",
        per_fill_wall_s=f"{t_a:.3f}", batch_wall_s=f"{wall - t_a:.3f}",
        ps=f"q{ps.queries}", segment_po2=MAIN_PO2,
        in_run_verify_s=json.dumps([round(c[2], 3) for c in per_fill.calls]
                                   ).replace(" ", ""),
        max_memory_allocated=peak,
        launches=json.dumps(launches).replace(" ", ""))
    say("market", task_seconds=json.dumps(
        {k: {"tasks": n, "s": round(t, 3)}
         for k, (n, t) in sorted(streams.items())}).replace(" ", ""))
    # each stored seal again, alone: its tensors lie on the host (the
    # object store's copy) and the verifier moves them to the card, where
    # the sponge runs its Merkle checks
    for req, fill, _ in a:
        host = fill.seal.root.segments[0].proof.data_root.device.type
        c0 = counts()["poseidon2_sponge"]
        t0 = time.perf_counter()
        ok = router(fill, req)
        dt = time.perf_counter() - t0
        sponge = counts()["poseidon2_sponge"] - c0
        if not ok or host != "cpu" or sponge <= 0:
            raise AssertionError(f"[market] seal verify on the card: ok={ok} "
                                 f"stored on {host}, {sponge} sponge "
                                 f"launches")
        say("market", seal=req.id.encoded(), stored_on=host,
            verified_on=str(dev), verify_s=f"{dt:.3f}",
            sponge_launches=sponge, verdict="accepted")
    # (c) one flipped word of a segment's public io
    req, fill, _ = a[0]
    bad = Fulfillment(request_id=fill.request_id, journal=fill.journal,
                      claim_digest=fill.claim_digest,
                      seal=tampered_seal(fill.seal), prover=fill.prover)
    c0 = counts()["poseidon2_sponge"]
    t0 = time.perf_counter()
    if router(bad, req):
        raise AssertionError("[market] a tampered seal was accepted")
    say("market", tampered_seal="rejected", verified_on=str(dev),
        verify_s=f"{time.perf_counter() - t0:.3f}",
        sponge_launches=counts()["poseidon2_sponge"] - c0)
    # (b) the batch's assessor guest, once more alone: two in-guest ECDSA
    # recoveries in the native executor
    fills = [(r, chain_b.request_sigs[r.id.encoded()], f) for r, f, _ in b]
    image, inp = batcher.Assessor().guest_session(fills)
    t0 = time.perf_counter()
    cycles, code, journal = fast_execute(image, inp)
    t_exec = time.perf_counter() - t0
    if code != 0 or journal != batcher.expected_assessor_journal(fills):
        raise AssertionError("[market] assessor guest run differs")
    say("market", assessor_fills=len(fills), assessor_cycles=cycles,
        assessor_s=f"{t_exec:.3f}", set_root_fulfilled=len(b))
    say("market", launches_market=json.dumps(launches).replace(" ", ""))
    return launches, [("per_fill", chain_a, len(a)),
                      ("batch", chain_b, len(b))]


# ---------------------------------------------------------------------------
# The STARK-to-Groth16 wrap: the p254 sponge, the MSM, the CRS prover and
# the CI wrap chain
# ---------------------------------------------------------------------------

P254_CHECK_N = 1 << 10
P254_CHECK_COLS = (48, 64, 24, 16)  # the identity proof's groups: ctrl,
# data, accum, check
P254_TIME_SHAPE = (1 << 16, 64)  # the identity data group at the CI params
# At the wrap's own shapes (2^16 rows, the four widths, and a 2^16-leaf
# commit) the plain version costs ~1 ms a permutation, so those launches
# are held to it on a sample: P254_SAMPLE spread rows or nodes plus the
# last P254_TAIL (the kernel's last thread block), and whole levels from
# P254_WHOLE nodes down.
P254_SAMPLE, P254_TAIL, P254_WHOLE = 128, 128, 1 << 10
P254_PATHS = 50  # opened paths of the 2^16-leaf commit walked on the card
MSM_PLAIN_N = 1 << 10
MSM_HOST_N = 1 << 12
# 497: the size of [groth16]'s CRS prover calls
MSM_TIME_N = (497, 1 << 16, 1 << 18, 1 << 20)
GROTH16_DEPTH = 2  # Merkle path of Poseidon-BN254 pair gadgets
# Montgomery products of one Poseidon-BN254 permutation in the reference's
# dense schedule (core/poseidon_bn254.permute): 8 full rounds of 3 S-boxes
# (3 products each) and 57 partial rounds of one, 9 MDS products a round.
# The parent's design did this work; its count stays as a second yardstick
# (the `_parent` bounds), so that time / bound compares the designs.
P254_PERM_MULS = 8 * (9 + 9) + 57 * (3 + 9)
# The products this design does (csrc/poseidon254.cu, one thread a hash):
# a full round 9 S-box products and 3 MDS rows of 3 (one reduction a row),
# a partial round its S-box, one row of 3 and 2 products (the sparse
# matrix). At 3 lanes a hash a partial round issues 3 S-boxes and 3 rows.
P254_PERM_PRODUCTS = 8 * (9 + 9) + 57 * (3 + 3 + 2)
# Dependent products on a permutation's critical path, in either layout:
# each of the 65 rounds an S-box (3) and then one MDS row (one sum of
# products, one reduction), which the next round's S-box waits on.
P254_PERM_DEPTH = 65 * (3 + 1)
# Montgomery products of a mixed (Jacobian + affine), a Jacobian addition
# and a doubling in csrc/msm.cu, and the dependent products on the
# critical path of an addition (mixed or not) and of a doubling.
MSM_MADD_MULS, MSM_ADD_MULS, MSM_DBL_MULS = 11, 16, 7
MSM_ADD_DEPTH, MSM_DBL_DEPTH = 5, 3


def bn_wide(k: int = 1) -> int:
    """32x32->64 products of bn254::mul_sum<M, K> (csrc/bn254_field.cuh):
    64 for each of the K products and one reduction (8 for the m_i, 64
    for m_i times the modulus); bn_wide(1) is one product (bn254::mul)."""
    return 64 * k + 72


# 32x32->64 products of one permutation in this design, one thread a hash
# (the least work of either layout): a full round 9 S-box products and 3
# MDS rows of mul_sum<3>; a partial round 3 S-box products, one row of
# mul_sum<3> and 2 products.
P254_PERM_WIDE = 8 * (9 * bn_wide() + 3 * bn_wide(3)) \
    + 57 * (5 * bn_wide() + bn_wide(3))


def bn_bound_ms(nbytes: float, wide: float, sm_clocks_per_s: float):
    """Bound of `wide` 32x32->64 products (see bn_wide) over `nbytes`: each
    the low and the high half of a product, two FMA-pipe issues (the least
    Hopper needs for a 64-bit product: it has no 64-bit multiplier).
    Carries and additions (ALU) are not counted, so the bound is low."""
    return bound_ms(nbytes, 0, 0, sm_clocks_per_s, extra=(2 * wide, 0, 0))


def bn_latency_ms(depth: float, lat: dict) -> float:
    """The least time of a chain of `depth` dependent BN254 products: the
    probed latency of bn254::mul<Fr> (SM clocks) at the maximum SM clock."""
    return depth * lat["bn_mul"] / lat["sm_hz"] * 1e3


def p254_row_wide(c: int, perm: int = P254_PERM_WIDE) -> int:
    """32x32->64 products of one p254 row hash of `c` words: the
    permutations (`perm` each; this design's by default), each felt's
    conversion into Montgomery form (one product) and the digest's out of
    it."""
    return p254_chain(c) * (perm + 2 * bn_wide()) + bn_wide()


def p254_levels_wide(n: int, top: int, perm: int = P254_PERM_WIDE) -> int:
    """32x32->64 products of the levels above `n` leaves as p254_levels
    forms them: n - 1 pair hashes, each a permutation and its digest out
    of Montgomery form; the levels launched one at a time take both
    digests of a pair into Montgomery form, the tree top its `top`-node
    level once."""
    top = min(n, top)
    return (n - 1) * (perm + bn_wide()) + (2 * (n - top) + top) * bn_wide()


def p254_row_products(c: int, perm: int = P254_PERM_MULS) -> int:
    """Montgomery products of one p254 row hash of `c` words: the
    permutations (`perm` products each; the dense schedule's, the parent's
    yardstick, by default), each felt's conversion into Montgomery form
    and the digest's out of it."""
    return p254_chain(c) * (perm + 2) + 1


def p254_parent_wide(n: int, c: int) -> tuple:
    """The parent's yardstick for the leaves of an n x c commit and for
    the levels above them (the dense schedule, 3 conversions a pair hash),
    in 32x32->64 products."""
    return (n * p254_row_products(c) * bn_wide(),
            (n - 1) * (P254_PERM_MULS + 3) * bn_wide())


def p254_chain(c: int) -> int:
    """Dependent permutations of one p254 row hash of `c` words."""
    return -(-max(1, -(-c // 8)) // 2)


def p254_sample(rng, n: int):
    """Row or node indices to hold a 2^16-size launch to the plain version:
    all of them from P254_WHOLE down, else a spread sample and the tail."""
    if n <= P254_WHOLE:
        return np.arange(n)
    spread = rng.choice(n - P254_TAIL, P254_SAMPLE, replace=False)
    return np.union1d(spread, np.arange(n - P254_TAIL, n))


def check_p254_sampled(check, rng, fn, inp, got, what) -> int:
    """Hold the rows `p254_sample` picks of `got` = fn(inp) on the card to
    fn on those rows of `inp` on the CPU; returns the rows checked."""
    idx = torch.from_numpy(p254_sample(rng, inp.shape[0])).to(inp.device)
    check(got[idx], fn(inp[idx].cpu()).to(inp.device), what)
    return int(idx.shape[0])


def phase_kernel_p254(dev, sm_clocks_per_s, lat):
    """The p254 sponge against its plain version (the Python-int hash) in
    every layout: whole at 2^10 rows (one thread and 3 lanes a hash), on
    2^10 pairs, the tree top at every level size and every level of a
    2^10-leaf commit; sampled at the wrap's 2^16 rows and on every level
    of a 2^16-leaf commit (its tree top too); the path walk of P254_PATHS
    opened paths of that commit, with a flipped and a refused sibling.
    Timed: a one-pair launch, the 2^16 x 64 leaves, the levels above them
    and the whole commit, each beside its throughput bound (this design's
    work), the parent's (the dense schedule's work) and its latency
    bound."""
    from boundless_tpu_torch.core import merkle, suites
    from boundless_tpu_torch.core import poseidon_bn254 as P254
    from boundless_tpu_torch.kernels import poseidon254 as P254K

    rng = np.random.default_rng(SEED + 7)
    check = Checker()
    suite = suites.get("poseidon254")
    for c in P254_CHECK_COLS:
        x = rand_words(rng, (P254_CHECK_N, c), dev)
        t0 = time.perf_counter()
        want = P254K.hash_rows(x.cpu())
        plain_s = time.perf_counter() - t0
        for g in (1, 3):
            got = P254K._hash_rows(x, g)
            check(got, want.to(dev), f"p254 rows {P254_CHECK_N}x{c} lanes{g}")
        if c == 64:
            plain_ms, x64 = plain_s * 1e3, x
    pairs = torch.cat([got, P254K.hash_rows(x64)], 1)  # 2^10 pairs
    want = P254K.hash_level(pairs.cpu()).to(dev)
    for g in (1, 3):
        check(P254K._hash_level(pairs, g), want, f"p254 pairs {P254_CHECK_N} "
              f"lanes{g}")
    m = 2
    while m <= P254K.TREE_TOP:  # the tree top at every level size
        for d, (g, w) in enumerate(zip(P254K.hash_tree(want[:m]),
                                       P254K.hash_tree(want[:m].cpu()))):
            check(g, w.to(dev), f"p254 tree top {m} level {d}")
        m *= 2
    tree = suite.commit(x64)
    t0 = time.perf_counter()  # the plain commit: the host's Python ints
    ref = [P254K.hash_rows(x64.cpu())]
    while ref[-1].shape[0] > 1:
        ref.append(P254K.hash_level(ref[-1].view(-1, 16)))
    commit_plain_ms = (time.perf_counter() - t0) * 1e3
    for d, (g, w) in enumerate(zip(tree.levels, ref)):
        check(g, w.to(dev), f"p254 commit level {d}")
    n, c = P254_TIME_SHAPE
    sampled = {}
    for cols in P254_CHECK_COLS:  # the wrap's launches at 2^16 rows
        if cols != c:
            y = rand_words(rng, (n, cols), dev)
            sampled[f"{n}x{cols}"] = check_p254_sampled(
                check, rng, P254K.hash_rows, y, P254K.hash_rows(y),
                f"p254 rows {n}x{cols}")
            del y
    x = rand_words(rng, (n, c), dev)
    leaves = P254K.hash_rows(x)
    sampled[f"{n}x{c}"] = check_p254_sampled(
        check, rng, P254K.hash_rows, x, leaves, f"p254 rows {n}x{c}")
    sampled[f"{n}x{c}_lanes3"] = check_p254_sampled(
        check, rng, P254K.hash_rows, x, P254K._hash_rows(x, 3),
        f"p254 rows {n}x{c} lanes3")
    tree = suite.commit(x)
    check(tree.levels[0], leaves, f"p254 commit {n} leaves")
    per_level = []
    for d in range(1, len(tree.levels)):
        below = tree.levels[d - 1].view(-1, 16)
        per_level.append(check_p254_sampled(
            check, rng, P254K.hash_level, below, tree.levels[d],
            f"p254 commit {n} level {d}"))
    # the path walk: every query's whole path in one launch
    idx = torch.from_numpy(rng.choice(n, P254_PATHS, replace=False)).to(dev)
    rows, paths = merkle.open_rows(tree, idx)
    leaf = P254K.hash_rows(rows)
    check(P254K.hash_paths(leaf, idx, paths),
          P254K.hash_paths(leaf.cpu(), idx.cpu(), paths.cpu()).to(dev),
          f"p254 path walk {P254_PATHS}x{paths.shape[1]}")
    if not bool(suite.verify_rows(tree.root, idx, rows, paths).all()):
        raise AssertionError("verify_rows refused the commit's own paths")
    bad = paths.clone()
    bad[3, 7, 0] ^= 1
    if suite.verify_rows(tree.root, idx, rows, bad).tolist() != \
            [i != 3 for i in range(P254_PATHS)]:
        raise AssertionError("verify_rows missed a flipped sibling")
    w = P254K.words_np(paths[5, 2])
    big = sum(int(v) << (32 * k) for k, v in enumerate(w)) + P254.FR
    bad = paths.clone()
    bad[5, 2] = P254K.words_tensor(
        [(big >> (32 * k)) & 0xFFFFFFFF for k in range(8)], dev)
    try:
        suite.verify_rows(tree.root, idx, rows, bad)
        raise AssertionError("verify_rows took a sibling of x + r")
    except ValueError:
        pass
    layouts = dict(P254K.LAUNCHES_BY_LAYOUT)
    if min(layouts.values()) <= 0:
        raise AssertionError(f"a p254 layout did not run: {layouts}")
    # times: the host's cost hidden for the one-pair launch (device_ms)
    pair = leaves[:2].reshape(1, 16)
    pair_ms = device_ms(lambda: P254K.hash_level(pair, trusted=True), 20)
    pair_plain_ms = host_ms(lambda: P254K.hash_level(pair.cpu(),
                                                     trusted=True), 5)
    ms = cuda_ms(lambda: P254K.hash_rows(x), 3)
    levels_ms = cuda_ms(lambda: p254_levels(leaves), 3)
    tree_ms = cuda_ms(lambda: suite.commit(x), 2)
    leaves_bytes = 4 * n * c + 32 * n
    levels_bytes = 64 * (n - 1) + 32 * (n - 1)
    leaves_wide = n * p254_row_wide(c)
    levels_wide = p254_levels_wide(n, P254K.TREE_TOP)
    bms, by = bn_bound_ms(leaves_bytes, leaves_wide, sm_clocks_per_s)
    lv_bms, lv_by = bn_bound_ms(levels_bytes, levels_wide, sm_clocks_per_s)
    tree_bms, tree_by = bn_bound_ms(leaves_bytes + 32 * (n - 1),
                                    leaves_wide + levels_wide,
                                    sm_clocks_per_s)
    leaves_par, levels_par = p254_parent_wide(n, c)
    bms_par = bn_bound_ms(leaves_bytes, leaves_par, sm_clocks_per_s)[0]
    lv_bms_par = bn_bound_ms(levels_bytes, levels_par, sm_clocks_per_s)[0]
    tree_bms_par = bn_bound_ms(leaves_bytes + 32 * (n - 1),
                               leaves_par + levels_par, sm_clocks_per_s)[0]
    depth = n.bit_length() - 1  # the levels: one permutation each
    lat_ms = bn_latency_ms(p254_chain(c) * P254_PERM_DEPTH, lat)
    products = n * p254_row_products(c, P254_PERM_PRODUCTS)
    say("kernel", kernel="p254_sponge", checked=check.checked,
        check_rows=P254_CHECK_N,
        check_cols=",".join(map(str, P254_CHECK_COLS)),
        sampled_rows=json.dumps(sampled).replace(" ", ""),
        commit_levels_checked=len(per_level),
        commit_nodes_checked_by_level=",".join(map(str, per_level)),
        path_walk=f"{P254_PATHS}x{paths.shape[1]}", flipped="refused",
        sibling_x_plus_r="raised",
        layouts=json.dumps(layouts).replace(" ", ""),
        tolerance=0, max_abs_err=check.max_err)
    say("kernel", kernel="p254_sponge", lane_crossover=P254K.LANE_CROSSOVER,
        tree_top=P254K.TREE_TOP, one_pair_ms=f"{pair_ms:.4f}",
        one_pair_plain_ms=f"{pair_plain_ms:.4f}",
        one_pair_latency_bound_ms=f"{bn_latency_ms(P254_PERM_DEPTH, lat):.4f}",
        shape=f"{n}x{c}", kernel_ms=f"{ms:.4f}", bound_ms=f"{bms:.4f}",
        bound_by=by, bound_parent_ms=f"{bms_par:.4f}",
        latency_bound_ms=f"{lat_ms:.4f}", products=products,
        wide_products=leaves_wide, wide_products_parent=leaves_par,
        tree_levels_ms=f"{levels_ms:.4f}",
        tree_levels_bound_ms=f"{lv_bms:.4f}", tree_levels_bound_by=lv_by,
        tree_levels_bound_parent_ms=f"{lv_bms_par:.4f}",
        tree_levels_latency_bound_ms=
        f"{bn_latency_ms(depth * P254_PERM_DEPTH, lat):.4f}",
        commit_ms=f"{tree_ms:.4f}", commit_bound_ms=f"{tree_bms:.4f}",
        commit_bound_by=tree_by, commit_bound_parent_ms=f"{tree_bms_par:.4f}",
        commit_latency_bound_ms=
        f"{bn_latency_ms((p254_chain(c) + depth) * P254_PERM_DEPTH, lat):.4f}",
        plain_ms_1024x64=f"{plain_ms:.4f}",
        commit_plain_ms_1024x64=f"{commit_plain_ms:.4f}")
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, latency_bound_ms=lat_ms,
                products=products, one_pair_ms=pair_ms, commit_ms=tree_ms,
                shape=f"{n}x{c}", plain_shape=f"{P254_CHECK_N}x64")


def p254_levels(leaves):
    """The levels above a commit's leaves, as Poseidon254Suite.commit
    forms them (one launch a level down to TREE_TOP nodes, then the tree
    top in one)."""
    from boundless_tpu_torch.kernels import poseidon254 as P254K

    cur = leaves
    while cur.shape[0] > P254K.TREE_TOP:
        cur = P254K.hash_level(cur.view(-1, 16), trusted=True)
    return P254K.hash_tree(cur)[-1]


def multiples_of_g(n: int):
    """Affine (x, y) ints of i * G, i = 1 .. n (host): the first 2B by
    repeated addition, then blocks of B affine additions of j * G to
    k * B * G (k >= 2, so no addition is a doubling), one inversion a
    block."""
    from boundless_tpu_torch.groth16 import msm_device as MD
    from boundless_tpu_torch.groth16.bn254 import G1, P as Q

    b = 1024
    g = G1.generator()
    first = [g]
    for _ in range(2 * b - 1):
        first.append(first[-1].add(g))
    out = MD.affine_batch(first)
    q = out[:b]
    cx, cy = out[-1]
    while len(out) < n:
        dx = [(qx - cx) % Q for qx, _ in q]
        pref, acc = [], 1
        for d in dx:
            pref.append(acc)
            acc = acc * d % Q
        inv = pow(acc, Q - 2, Q)
        block = [None] * b
        for j in range(b - 1, -1, -1):
            dinv = pref[j] * inv % Q
            inv = inv * dx[j] % Q
            qx, qy = q[j]
            lam = (qy - cy) * dinv % Q
            x3 = (lam * lam - cx - qx) % Q
            block[j] = (x3, (lam * (cx - x3) - cy) % Q)
        out.extend(block)
        cx, cy = block[-1]
    return out[:n]


def affine_words(points) -> np.ndarray:
    """Affine (x, y) ints -> (n, 16) uint32 Montgomery words."""
    from boundless_tpu_torch.groth16 import limbs as LB
    from boundless_tpu_torch.groth16.bn254 import P as Q

    blob = b"".join((x * LB.R_MOD_N % Q).to_bytes(32, "little")
                    + (y * LB.R_MOD_N % Q).to_bytes(32, "little")
                    for x, y in points)
    return np.frombuffer(blob, dtype=np.uint32).reshape(-1, 16)


def msm_products(scalars, dev) -> int:
    """Montgomery products of the reference's schedule on these scalars
    (boundless_tpu/groth16/msm_tpu.py: unsigned 8-bit digits in 32 x 255
    buckets, a suffix sum a window), the parent's design and the yardstick
    the `_parent` bound counts: a
    mixed addition for each entry after a chunk's first (chunks of 32), a
    Jacobian addition for each chunk after a bucket's first, the
    windows' running sums (2 x 255 additions each) and the 31 joins (8
    doublings, 1 addition)."""
    from boundless_tpu_torch.groth16 import msm_device as MD

    d = MD.digits(scalars, dev).to(torch.int64)
    keys = (d + torch.arange(32, device=dev) * 256)[d != 0]
    counts = torch.bincount(keys, minlength=32 * 256)
    entries = int(counts.sum())
    chunks = int(((counts + 31) // 32).sum())
    buckets = int((counts > 0).sum())
    return ((entries - chunks) * MSM_MADD_MULS
            + (chunks - buckets) * MSM_ADD_MULS
            + 32 * 2 * 255 * MSM_ADD_MULS
            + 31 * (8 * MSM_DBL_MULS + MSM_ADD_MULS))


def msm_products_new(pr) -> int:
    """Montgomery products this design does on these inputs, which its
    bound counts: the chunks' and buckets' additions as above, 32 x 7 bit
    slices of 64 buckets (8 lanes of 7 additions, 3 butterfly steps on
    each lane), each window's 7 doublings and additions, the 31 joins."""
    entries = pr.idx.shape[0]
    chunks = pr.chunk_start.shape[0]
    buckets = int((pr.bucket_chunks > 0).sum())
    return ((entries - chunks) * MSM_MADD_MULS
            + (chunks - buckets) * MSM_ADD_MULS
            + 32 * 7 * 8 * (7 + 3) * MSM_ADD_MULS
            + 32 * 7 * (MSM_DBL_MULS + MSM_ADD_MULS)
            + 31 * (8 * MSM_DBL_MULS + MSM_ADD_MULS))


def msm_depth(pr) -> int:
    """Dependent products on the MSM's longest chain: the longest chunk,
    the bucket with the most chunks, a bit slice (8 additions and 3
    butterfly steps), a window (7 doublings and additions) and the join
    (31 x (8 doublings + 1 addition))."""
    longest = int(pr.chunk_len.max()) if pr.chunk_len.numel() else 0
    most = int(pr.bucket_chunks.max())
    return ((longest + most + 11) * MSM_ADD_DEPTH
            + 7 * (MSM_DBL_DEPTH + MSM_ADD_DEPTH)
            + 31 * (8 * MSM_DBL_DEPTH + MSM_ADD_DEPTH))


def phase_kernel_msm(dev, sm_clocks_per_s, lat):
    """The CUDA MSM against its plain version, the host Pippenger (with
    the signed digits' edge cases) and the i*G identity, and timed."""
    from boundless_tpu_torch.groth16 import limbs as LB
    from boundless_tpu_torch.groth16 import msm as HM
    from boundless_tpu_torch.groth16 import msm_device as MD
    from boundless_tpu_torch.groth16.bn254 import G1, R
    from boundless_tpu_torch.kernels import msm as MK

    rng = np.random.default_rng(SEED + 8)
    t0 = time.perf_counter()
    aff = multiples_of_g(max(MSM_TIME_N))
    gen_s = time.perf_counter() - t0
    words = torch.from_numpy(affine_words(aff).view(np.int32).copy())
    check = Checker()

    def affine(w):  # (24,) Jacobian words -> (16,) affine limbs
        p = MD.point_from_words(w.cpu().numpy()).to_affine()
        return np.zeros(16, np.int64) if p is None else np.concatenate(
            [LB.to_limbs(p[0]), LB.to_limbs(p[1])]).astype(np.int64)

    def scalars_of(n, edge):
        out = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        if edge:  # zeros, one, repeated digits (tests/test_msm_tpu.py:55-70)
            out[3] = 0
            out[11] = 1
            out[12] = out[13] = out[14] = 5
            out[20] = out[21]
            # the signed digits' edges: r - 1, digits of exactly 128 and
            # of -127, a scalar and its negation
            out[15] = R - 1
            out[16] = int.from_bytes(bytes([0x80] * 31), "little")
            out[17] = int.from_bytes(bytes([0x81] * 31), "little")
            out[18] = R - out[19]
        return out

    # the plain torch version at 2^10 (edge cases: an infinity point, a
    # point and its negation, repeated points and scalars)
    n = MSM_PLAIN_N
    pts = words[:n].clone()
    pts[7] = 0  # infinity
    neg = MD.points_words([G1.from_affine(aff[8]).neg()])
    pts[9] = torch.from_numpy(neg.view(np.int32).copy())[0]
    pts[30] = pts[31]
    sc = scalars_of(n, True)
    sc[30] = sc[31]
    sc[9] = sc[8]
    pts = pts.to(dev)
    pr = MD.prep(sc, dev)
    got = MK.pippenger(pts, pr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = MD.plain_pippenger(pts, pr)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int(np.abs(affine(got) - affine(plain)).max())
    check.max_err = max(check.max_err, err)
    if err:
        raise AssertionError("MSM kernel differs from its plain version")
    # the host Pippenger at 2^12, with random points and the edge cases:
    # a point and its negation under one scalar (P + -P in a bucket), a
    # point twice under opposite scalars (P and P through both signs)
    n = MSM_HOST_N
    g = G1.generator()
    hp = [g.mul(int(k)) for k in rng.integers(1, 1 << 40, size=n)]
    hp[20] = G1.infinity()
    hp[40] = hp[41].neg()
    hp[50] = hp[51]
    hp[60] = hp[61]
    hs = scalars_of(n, True)
    hs[40], hs[50], hs[60] = hs[41], hs[51], R - hs[61]
    got = MD.msm(hp, hs, dev)
    if not got.eq(HM.msm_pippenger(hp, hs)):
        raise AssertionError("MSM kernel differs from the host Pippenger")
    if not MD.msm([g, g], [1, R - 1], dev).is_infinity():
        raise AssertionError("MSM kernel: G + (r - 1) G is not infinity")
    check.checked += 3
    # i*G: sum_i s_i (i G) = (sum_i i s_i mod r) G
    times = {}
    for n in MSM_TIME_N:
        sc = scalars_of(n, False)
        pts = words[:n].to(dev)
        pr = MD.prep(sc, dev)
        out = MK.pippenger(pts, pr)
        want = g.mul(sum((i + 1) * s for i, s in enumerate(sc)) % R)
        if not MD.point_from_words(out.cpu().numpy()).eq(want):
            raise AssertionError(f"MSM kernel: the i*G check fails at n={n}")
        check.checked += 1
        ms = cuda_ms(lambda: MK.pippenger(pts, pr), 3)
        nbytes = 64 * n + 32 * n + 96
        products, parent = msm_products_new(pr), msm_products(sc, dev)
        bms, by = bn_bound_ms(nbytes, products * bn_wide(), sm_clocks_per_s)
        bms_par = bn_bound_ms(nbytes, parent * bn_wide(), sm_clocks_per_s)[0]
        lat_ms = bn_latency_ms(msm_depth(pr), lat)
        times[n] = (ms, bms, by, lat_ms, products)
        say("kernel", kernel="bn254_msm", n=n, entries=pr.idx.shape[0],
            chunks=pr.chunk_start.shape[0], i_times_g="equal",
            kernel_ms=f"{ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
            bound_parent_ms=f"{bms_par:.4f}",
            latency_bound_ms=f"{lat_ms:.4f}", products=products,
            products_parent=parent)
    n = max(MSM_TIME_N)
    ms, bms, by, lat_ms, products = times[n]
    say("kernel", kernel="bn254_msm", checked=check.checked, tolerance=0,
        max_abs_err=check.max_err, plain_n=MSM_PLAIN_N,
        plain_ms=f"{plain_ms:.4f}", host_pippenger_n=MSM_HOST_N,
        host_points_s=f"{gen_s:.3f}")
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, latency_bound_ms=lat_ms,
                products=products, ms_497=times[497][0],
                shape=f"{n} points", plain_shape=f"{MSM_PLAIN_N} points")


def merkle_circuit(depth: int, rng):
    """An R1CS proving a Merkle path of Poseidon-BN254 pair hashes
    (`r1cs.poseidon_hash_pair`, the wrap circuit's building block) to a
    public root: leaf, siblings and direction bits are witness."""
    from boundless_tpu_torch.core import poseidon_bn254 as P254
    from boundless_tpu_torch.groth16 import circuit, r1cs

    leaf = int.from_bytes(rng.bytes(32), "little") % P254.FR
    sibs = [int.from_bytes(rng.bytes(32), "little") % P254.FR
            for _ in range(depth)]
    bits = [int(b) for b in rng.integers(0, 2, size=depth)]
    cur = leaf
    for s, b in zip(sibs, bits):
        cur = P254.hash_pair(s, cur) if b else P254.hash_pair(cur, s)
    bld = r1cs.Builder(concrete=True)
    root = bld.pub_var(cur)
    bld.freeze_pub()
    node = bld.lc(bld.wit(leaf))
    for s, b in zip(sibs, bits):
        sib = bld.lc(bld.wit(s))
        bit = bld.bit(b)
        left = circuit.select_felt(bld, bit, sib, node)
        right = circuit.select_felt(bld, bit, node, sib)
        node = r1cs.poseidon_hash_pair(bld, left, right)
    bld.enforce_zero(r1cs._lc_add(node, r1cs._lc_scale(bld.lc(root),
                                                       r1cs.FR - 1)))
    return bld, cur


def phase_groth16(dev):
    """The CRS prover's path on the card: setup_sparse + prove_sparse,
    whose G1 MSMs run through the CUDA Pippenger."""
    from boundless_tpu_torch.groth16 import protocol, qap

    rng = np.random.default_rng(SEED + 9)
    bld, root = merkle_circuit(GROTH16_DEPTH, rng)
    sys_ = bld.to_sparse()
    wit = bld.witness()
    if not sys_.is_satisfied(wit):
        raise AssertionError("the Merkle-path circuit is not satisfied")
    t0 = time.perf_counter()
    pk, vk = qap.setup_sparse(sys_)
    t_setup = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    proof = qap.prove_sparse(sys_, pk, wit, device=dev)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    launches = all_counts()
    if launches["bn254_msm"] <= 0:
        raise AssertionError("prove_sparse launched no MSM kernel")
    t0 = time.perf_counter()
    ok = protocol.verify(vk, proof, [root])
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the CRS prover's proof does not verify")
    if protocol.verify(vk, proof, [(root + 1) % protocol.R]):
        raise AssertionError("verify accepted a tampered public input")
    say("groth16", circuit=f"merkle_path_depth{GROTH16_DEPTH}",
        rows=len(sys_.rows), variables=sys_.n_vars,
        msm_points=f"{len(pk.a_g1)},{len(pk.b_g1)},{len(pk.l_g1)},"
        f"{len(pk.h_g1)}", setup_sparse_s=f"{t_setup:.3f}",
        prove_sparse_s=f"{t_prove:.3f}", verify_s=f"{t_verify:.3f}",
        verify="accepted", tampered_public="rejected",
        launches=json.dumps(launches).replace(" ", ""))
    return launches


def ci_session(dev):
    """The JAX CI wrap chain's session receipt on the card
    (tests/test_groth16_wrap.py:20-44): echo guest words([1, 7]), seg po2
    6, q2 / fri_min 16 / rate 1/2, rec_po2 17, both lift variants ->
    (recursion system, session, its build s, segment proof and lift s)."""
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import succinct
    from boundless_tpu_torch.zkvm import guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    ps = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
    params = succinct.SuccinctParams(seg_po2=6, seg_ps=ps, rec_po2=17,
                                     rec_ps=ps, variants=("rv32im", "rv32i"))
    image = guests.echo()
    res = Executor(image, guests.words([1, 7]), segment_po2=6).run()
    if len(res.segments) != 1:
        raise AssertionError(f"{len(res.segments)} segments, expected 1")
    t0 = time.perf_counter()
    system = succinct.SuccinctSystem(params, device=dev)
    t_system = time.perf_counter() - t0
    t0 = time.perf_counter()
    sr = prove.prove_segment(image, res.segments[0], ps, device=dev)
    root = system.lift(sr, pre_mem=res.segments[0].pre_mem)
    torch.cuda.synchronize()
    t_lift = time.perf_counter() - t0
    if not system.verify(root):
        raise AssertionError("the lift receipt does not verify")
    words = [int.from_bytes(res.journal[i: i + 4], "little")
             for i in range(0, len(res.journal), 4)]
    session = succinct.finalize_session(root, words, image.entry,
                                        paging.image_root(image))
    return system, session, t_system, t_lift


def phase_wrap(dev):
    """The JAX CI wrap chain (tests/test_groth16_wrap.py:20-44) on the
    card: echo session -> lift -> finalize -> identity_p254 -> R1CS wrap
    circuit -> Groth16 -> pairing-only verify; the EVM seal round-trip;
    tampers refused."""
    from boundless_tpu_torch.groth16 import evm, wrap
    from boundless_tpu_torch.kernels import poseidon254 as P254K
    from boundless_tpu_torch.recursion import identity

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    system, session, t_system, t_lift = ci_session(dev)
    t0 = time.perf_counter()
    p254 = identity.get_p254(system)
    t_p254 = time.perf_counter() - t0
    before = P254K.LAUNCHES  # the control ID's launches stay counted
    with Stages() as shrink:
        receipt = wrap.compress(session, kind="groth16", system=system)
        torch.cuda.synchronize()
    shrink_launches = P254K.LAUNCHES - before
    sec = dict(p254.seconds, **shrink.seconds)
    launches = all_counts()
    if launches["p254_sponge"] <= 0:
        raise AssertionError("identity_p254 launched no p254 sponge kernel")
    layouts = dict(P254K.LAUNCHES_BY_LAYOUT)
    if min(layouts.values()) <= 0:  # the shrink runs every layout
        raise AssertionError(f"a p254 layout did not run: {layouts}")
    t0 = time.perf_counter()
    ok = wrap.verify(receipt, system=system)
    t_verify = time.perf_counter() - t0
    if not ok or receipt.dev_mode:
        raise AssertionError("wrap.verify rejected the Groth16 receipt")
    if not wrap.verify(receipt, expected_image_id=receipt.image_id,
                       system=system):
        raise AssertionError("wrap.verify rejected the expected image id")
    bad = dataclasses.replace(receipt, journal=receipt.journal[:-4]
                              + b"\x01\x02\x03\x04")
    if wrap.verify(bad, system=system):
        raise AssertionError("wrap.verify accepted a tampered journal")
    seal = receipt.inner
    bad_claim = dataclasses.replace(seal.claim, post_journal=tuple([1] * 8))
    if wrap.verify(dataclasses.replace(receipt, inner=dataclasses.replace(
            seal, claim=bad_claim)), system=system):
        raise AssertionError("wrap.verify accepted a tampered claim")
    calldata = evm.encode_seal(receipt)
    dec = evm.decode_seal(calldata)
    if not evm.verify_decoded(dec, seal.vk):
        raise AssertionError("the decoded EVM seal does not verify")
    wk = wrap.wrap_key_for(p254)
    # the sponge's device time by kind in one more warm shrink and verify
    shr = profile_sponge("wrap", "identity_p254 shrink",
                         lambda: p254.shrink(session.root), sponge="p254")
    profile_sponge("wrap", "identity_p254 verify", lambda: p254.verify(shr),
                   sponge="p254")
    say("wrap", stage="setup", recursion_system_s=f"{t_system:.3f}",
        segment_and_lift_s=f"{t_lift:.3f}", identity_system_s=f"{t_p254:.3f}",
        identity_program_build_s=f"{sec['program_build']:.3f}",
        p254_control_id_s=f"{sec['control_id']:.3f}",
        identity_po2=p254.po2,
        control_id=",".join(str(x) for x in p254.control_id))
    say("wrap", stage="identity_p254",
        shrink_s=f"{sec['proof']:.3f}",
        witness_s=f"{sec['witness']:.3f}",
        native_eval_s=f"{sec['native_eval']:.3f}",
        prove_s=f"{sec['prove']:.3f}", verify_s=f"{sec['verify']:.3f}",
        p254_sponge_launches_shrink_and_verify=shrink_launches,
        p254_layouts=json.dumps(layouts).replace(" ", ""))
    say("wrap", stage="groth16", prover_mode=wk.mode, r1cs_rows=wk.n_rows,
        r1cs_variables=wk.n_vars,
        r1cs_layout_s=f"{wk.seconds['r1cs_layout']:.3f}",
        setup_s=f"{wk.seconds['setup']:.3f}",
        concrete_build_s=f"{wk.seconds['concrete_build']:.3f}",
        prove_s=f"{wk.seconds['prove']:.3f}", verify_s=f"{t_verify:.3f}",
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("wrap", stage="receipt", selector=receipt.selector,
        dev_mode=receipt.dev_mode, verify="accepted",
        tampered_journal="rejected", tampered_claim="rejected",
        evm_seal_bytes=len(calldata), evm_round_trip="verified",
        wall_s=f"{time.perf_counter() - t_all:.3f}",
        launches=json.dumps(launches).replace(" ", ""))
    return launches


# ---------------------------------------------------------------------------
# The developer and market tools on the card: the degree audit, the trace
# checker, data-parallel proving, PoVW and the market services
# ---------------------------------------------------------------------------

AUDIT_PO2, AUDIT_EXPAND = 5, 16
DEGREE_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "torch_degree_golden.npz")
DEBUG_PO2 = 8  # the CPU plain path's small witness
DEBUG_ROW = 3  # the flipped word: an active row's rdv limb


def audit_cases(dev):
    """(name, AIR, publics on `dev`) of the four audited AIRs, with the
    publics of tests/data/make_torch_degree_golden.py."""
    from boundless_tpu_torch import cli
    from boundless_tpu_torch.air import keccak as K
    from boundless_tpu_torch.air import rv32im as R
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.recursion import air as rair
    from boundless_tpu_torch.recursion import vm

    rng = np.random.default_rng(0)
    states = rng.integers(0, F.P, size=(K.max_perms(AUDIT_PO2),
                                        1 + 2 * K.LIMBS), dtype=np.uint32)
    return [(name, R.Rv32imAir(name == "rv32im"),
             cli.rv32im_audit_pub(np.random.default_rng(0), dev))
            for name in ("rv32im", "rv32i")] + [
        ("recursion", rair.AIR, rair.pub_array([0] * vm.PUB_VALS, dev)),
        ("keccak", K.KeccakAir(), K.PublicValues(
            states=torch.from_numpy(states.astype(np.int32)).to(dev)))]


def phase_audit(dev):
    """`degree.assert_degrees` on the card at po2 5, expand 16, for rv32im,
    rv32i, RecursionAir and KeccakAir: every lane's degree equal to the
    JAX golden, the NTT kernel launched."""
    from boundless_tpu_torch.air import degree as DA

    gold = np.load(DEGREE_GOLDEN)
    zero_counts()
    for name, air, pub in audit_cases(dev):
        t0 = time.perf_counter()
        degs = DA.assert_degrees(air, pub, po2=AUDIT_PO2,
                                 expand=AUDIT_EXPAND, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"index": [d.index for d in degs],
               "lane": [d.lane for d in degs],
               "kind": [d.kind for d in degs],
               "degree": [d.degree for d in degs]}
        bad = [k for k, v in got.items()
               if v != gold[f"{name}/{k}"].tolist()]
        if bad:
            raise AssertionError(f"[audit] {name}: {bad} differ from the JAX "
                                 f"golden")
        n = 1 << AUDIT_PO2
        worst = max(got["degree"])
        say("audit", air=name, constraints=len(set(got["index"])),
            lanes=len(degs), po2=AUDIT_PO2, expand=AUDIT_EXPAND,
            worst_degree=worst, worst_mult=round(worst / (n - 1), 3),
            declared=air.max_degree, budget=DA.degree_budget(AUDIT_PO2),
            vs_jax="equal", s=f"{secs:.3f}")
    launches = all_counts()
    if launches["ntt_sub_transform"] <= 0:
        raise AssertionError(f"[audit] the NTT kernel was not launched: "
                             f"{launches}")
    say("audit", launches=json.dumps(launches).replace(" ", ""))
    return launches


def tampered_rdv(data):
    """`data` with DEBUG_ROW's rdv limb bumped by one."""
    from boundless_tpu_torch.air.rv32im import DC
    from boundless_tpu_torch.core import field as F

    bad = data.copy()
    bad[DEBUG_ROW, DC.rdv.start] = (bad[DEBUG_ROW, DC.rdv.start] + 1) % F.P
    return bad


def phase_debug(dev, w):
    """`debug.check_constraints` on the card on the main path's po2-17
    rv32i witness `w`: ok; with one word flipped, failures naming the same
    constraints as the CPU plain path on a po2-8 witness flipped the same
    way."""
    from boundless_tpu_torch.air import debug
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.zkvm import guests, prove, witness
    from boundless_tpu_torch.zkvm.executor import Executor

    air = prove._AIRS["rv32i"]

    def check(w, data, device):
        t0 = time.perf_counter()
        out = debug.check_constraints(
            air, F.fp(w.ctrl, device), F.fp(data, device),
            witness.to_public_values(w.pub, device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    data = witness.data_for_variant(w.data, "rv32i")
    (ok, failures), secs = check(w, data, dev)
    if not ok:
        raise AssertionError(f"[debug] the main witness fails {failures}")
    (ok_bad, bad), bad_secs = check(w, tampered_rdv(data), dev)
    image = guests.loop_guest()
    seg = Executor(image, guests.words([((1 << DEBUG_PO2) - 40) // 2]),
                   segment_po2=DEBUG_PO2).run().segments[0]
    small = prove._gen_witness(image, seg)
    (ok_cpu, cpu), cpu_secs = check(
        small, tampered_rdv(witness.data_for_variant(small.data, "rv32i")),
        "cpu")
    names = [i for i, _ in bad]
    if ok_bad or not bad or names != [i for i, _ in cpu]:
        raise AssertionError(f"[debug] tampered: card {bad}, CPU plain "
                             f"path {cpu}")
    say("debug", air=air.name, po2=MAIN_PO2, rows=data.shape[0],
        witness="main", ok=ok, s=f"{secs:.3f}",
        tampered_failures=json.dumps(bad).replace(" ", ""),
        tampered_s=f"{bad_secs:.3f}",
        cpu_po2=DEBUG_PO2, cpu_failures=json.dumps(cpu).replace(" ", ""),
        cpu_s=f"{cpu_secs:.3f}", indices_vs_cpu="equal")


class RecordChained:
    """Records (rows, columns, out_words, from a state) of every
    `kernels/poseidon2.hash_rows` call over input columns that starts from
    a state or returns it whole (the parts of a chained leaf hash) while
    active."""

    def __enter__(self):
        from boundless_tpu_torch.kernels import poseidon2 as P2K

        self.seen = []
        self._k, self._orig = P2K, P2K.hash_rows

        def hash_rows(matrix, init=None, out_words=8):
            if matrix.shape[1] and (init is not None or out_words > 8):
                self.seen.append((matrix.shape[0], matrix.shape[1],
                                  out_words, init is not None))
            return self._orig(matrix, init, out_words)

        P2K.hash_rows = hash_rows
        return self

    def __exit__(self, *exc):
        self._k.hash_rows = self._orig


def same_proof(got, want) -> bool:
    from boundless_tpu_torch import convert

    g, w = convert.proof_to_numpy(got), convert.proof_to_numpy(want)
    return sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k])
                                          for k in g)


def mesh_run(fn, placed, devices):
    """One proving call on a mesh with the counts zeroed just before and
    read right after: (proofs, wall s, launches, moved bytes, the chained
    sponge launches, each device's peak allocated bytes)."""
    from boundless_tpu_torch.parallel import mesh as M

    devices = sorted(set(devices), key=str)
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    zero_counts()
    M.MOVED_BYTES = 0
    with RecordChained() as chained:
        t0 = time.perf_counter()
        proofs = fn(*placed)
        for d in devices:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    return (proofs, wall, all_counts(), M.MOVED_BYTES, chained.seen,
            {str(d): torch.cuda.max_memory_allocated(d) for d in devices})


def phase_mesh(dev):
    """The main path's loop-guest session (two po2-17 segments) proved on
    a mesh of every card (dp; world size 1 on one card) and on a (1, 2)
    mesh that names the card twice (tp: each proof spread by trace
    columns, `parallel/mesh.py`), and with more than one card on a
    (1, count) mesh of distinct cards; each proof word for word equal to
    `stark.prove` of the same trace on the card. Prints the walls, peaks
    and launches of the tp proofs beside the single proofs', the bytes
    moved between the tp group's positions and the chained leaf-hash
    launches."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.parallel import mesh as M
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.zkvm import guests, prove, witness
    from boundless_tpu_torch.zkvm.executor import Executor

    image = guests.loop_guest()
    res = Executor(image, guests.words([((1 << MAIN_PO2) - 40) // 2]),
                   segment_po2=MAIN_PO2).run()
    if len(res.segments) != 2:
        raise AssertionError(f"[mesh] {len(res.segments)} segments")
    variant = prove.air_variant_of(image, res.segments[0])
    air = prove._AIRS[variant]
    ws = [prove._gen_witness(image, seg) for seg in res.segments]
    data = [F.fp(witness.data_for_variant(w.data, variant), dev) for w in ws]
    pubs = [witness.to_public_values(w.pub, dev) for w in ws]
    ctrl, _ = prove._image_ctrl(image, MAIN_PO2, prove.DEFAULT_PS, dev)
    mesh = M.make_mesh()
    if mesh.shape != {"dp": torch.cuda.device_count(), "tp": 1}:
        raise AssertionError(f"[mesh] mesh {mesh.shape}")
    fn, shard_fn = M.shard_batched_prover(air, MAIN_PO2, prove.DEFAULT_PS,
                                          mesh)
    proofs, t_mesh, launches, _, _, _ = mesh_run(
        fn, shard_fn(data, pubs, ctrl), mesh.devices.flat)
    if min(launches[k] for k in ("poseidon2_sponge", "ntt_sub_transform",
                                 "cons_eval")) <= 0:
        raise AssertionError(f"[mesh] skipped a kernel: {launches}")

    def prove_singles():
        return [stark.prove(air, d, p, MAIN_PO2, prove.DEFAULT_PS, ctrl)
                for d, p in zip(data, pubs)]

    singles, t_single, single_launches, _, _, single_peak = mesh_run(
        prove_singles, (), [dev])
    for i, (got, want) in enumerate(zip(proofs, singles)):
        if not same_proof(got, want):
            raise AssertionError(f"[mesh] segment {i}: the mesh proof "
                                 f"differs from stark.prove")
        if got.data_root.device != dev:
            raise AssertionError("[mesh] a proof did not run on the card")
    say("mesh", mesh=json.dumps(mesh.shape).replace(" ", ""),
        segments=len(proofs), variant=variant, po2=MAIN_PO2,
        mesh_s=f"{t_mesh:.3f}", single_s=f"{t_single:.3f}",
        vs_stark_prove="equal",
        launches=json.dumps(launches).replace(" ", ""))

    # tp: the same segments, each proof spread by columns over a group;
    # on one card the group names it twice, timed in turns with the
    # singles (single, tp, tp, single)
    tp_meshes = [("card_twice", M.make_mesh(devices=[dev, dev], dp=1))]
    if torch.cuda.device_count() > 1:
        tp_meshes.append(("cards", M.make_mesh(dp=1)))
    per_proof = {k: v // len(data) for k, v in single_launches.items()}
    for name, tm in tp_meshes:
        fn, shard_fn = M.shard_batched_prover(air, MAIN_PO2,
                                              prove.DEFAULT_PS, tm)
        placed = shard_fn(data, pubs, ctrl)
        got, t_tp, tp_launches, moved, chained, peaks = mesh_run(
            fn, placed, tm.devices.flat)
        t_tp = [t_tp, mesh_run(fn, placed, tm.devices.flat)[1]]
        del placed
        t_single2 = mesh_run(prove_singles, (), [dev])[1]
        for k, v in tp_launches.items():
            launches[k] += v
        for i, (g, want) in enumerate(zip(got, singles)):
            if not same_proof(g, want):
                raise AssertionError(f"[mesh] {name} segment {i}: the tp "
                                     f"proof differs from stark.prove")
            if g.data_root.device != tm.devices[0, 0]:
                raise AssertionError(f"[mesh] {name}: a proof left the "
                                     f"leader")
        if min(tp_launches[k] for k in ("poseidon2_sponge",
                                        "ntt_sub_transform", "cons_eval",
                                        "bb_weighted_sum")) <= 0:
            raise AssertionError(f"[mesh] {name} skipped a kernel: "
                                 f"{tp_launches}")
        widths = [b - a for a, b in M.column_split(air.data_cols,
                                                   tm.devices.shape[1])]
        # the data group's leaf hash: every shard but the last returns the
        # whole state, every shard but the first starts from one
        rows = prove.DEFAULT_PS.commit_expand << MAIN_PO2
        want = {(rows, w, 24, i > 0) for i, w in
                enumerate(widths[:-1])} | {(rows, widths[-1], 8,
                                            True)}
        if not want <= set(chained):
            raise AssertionError(f"[mesh] {name}: the data leaves were not "
                                 f"chained: {sorted(set(chained))}")
        say("mesh", tp_mesh=name, shape=json.dumps(tm.shape).replace(" ", ""),
            cards=len({str(d) for d in tm.devices.flat}),
            segments=len(got), vs_stark_prove="equal",
            data_shards="|".join(map(str, widths)),
            ctrl_shards="|".join(str(b - a) for a, b in M.column_split(
                air.ctrl_cols, tm.devices.shape[1])),
            tp_s=",".join(f"{t:.3f}" for t in t_tp),
            single_s=f"{t_single:.3f},{t_single2:.3f}",
            tp_peak_bytes=json.dumps(peaks).replace(" ", ""),
            single_peak_bytes=json.dumps(single_peak).replace(" ", ""),
            moved_bytes_per_proof=moved // len(got),
            chained_sponge_launches_per_proof=len(chained) // len(got),
            launches_per_tp_proof=json.dumps(
                {k: v // len(got) for k, v in tp_launches.items()}
            ).replace(" ", ""),
            launches_per_single_proof=json.dumps(per_proof).replace(" ", ""))
    return launches


def phase_povw(system, session):
    """PoVW on [recursion]'s session receipt: `record_receipt` credits its
    segments << MAIN_PO2 cycles after `verify_session` on the card; a
    second record of the claim and a forged segment count raise; the
    closed epoch mints."""
    from boundless_tpu_torch.market import povw

    clock = [0.0]
    log = povw.WorkLog(epoch_seconds=60.0, clock=lambda: clock[0])
    zero_counts()
    t0 = time.perf_counter()
    cycles = log.record_receipt("prover1", session, system,
                                seg_po2=MAIN_PO2)
    secs = time.perf_counter() - t0
    launches = all_counts()
    c = session.root.claim
    segments = int(c.post_segments) - int(c.pre_segments)
    if segments != 2 or cycles != segments << MAIN_PO2:
        raise AssertionError(f"[povw] credited {cycles} cycles for "
                             f"{segments} segments")
    if launches["poseidon2_sponge"] <= 0:
        raise AssertionError(f"[povw] verify_session launched no sponge: "
                             f"{launches}")
    forged = dataclasses.replace(session, root=dataclasses.replace(
        session.root, claim=dataclasses.replace(
            c, post_segments=c.post_segments + 100)))
    for what, receipt in (("again", session), ("forged", forged)):
        try:
            log.record_receipt("prover2", receipt, system, seg_po2=MAIN_PO2)
        except ValueError:
            continue
        raise AssertionError(f"[povw] a {what} receipt was credited")
    clock[0] = 60.0
    mints = povw.MintCalculator(log).mint_for_epoch(0)
    if mints != {"prover1": 1_000_000}:
        raise AssertionError(f"[povw] mints {mints}")
    say("povw", cycles=cycles, segments=segments, record_s=f"{secs:.3f}",
        again="refused", forged_segments="refused",
        mints=json.dumps(mints).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""))
    return launches


def phase_services(chains):
    """The market services on [market]'s chains: `IndexerService` syncs
    each chain's events (locked and fulfilled counts equal the phase's
    fills) and its localhost API answers /stats; `Indexer` and `Slasher`
    run once."""
    import urllib.request

    from boundless_tpu_torch.market import indexer_service, services

    for mode, chain, fills in chains:
        svc = indexer_service.IndexerService(chain)
        t0 = time.perf_counter()
        ingested = svc.sync()
        secs = time.perf_counter() - t0
        stats = svc.stats()
        locked = sum(e["kind"] == "RequestLocked" for e in svc.events(0))
        if (stats["total_requests"], locked, stats["total_fulfilled"]) != (
                fills, fills, fills):
            raise AssertionError(f"[services] {mode}: {stats}, {locked} "
                                 f"locked, {fills} fills")
        server, thread = indexer_service.make_indexer_server(svc)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/stats"
            with urllib.request.urlopen(url, timeout=10) as r:
                served = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
        if served != stats:
            raise AssertionError(f"[services] /stats {served} vs {stats}")
        agg = services.Indexer(chain).sync()
        if (agg.total_fulfilled, agg.total_volume) != (
                fills, stats["total_volume"]):
            raise AssertionError(f"[services] Indexer {agg}")
        slasher = services.Slasher(chain, "watcher", poll=0.01)
        slasher.start()
        time.sleep(0.05)
        slasher.stop()
        slasher._thread.join(timeout=5)
        if slasher.slashed:
            raise AssertionError(f"[services] slashed {slasher.slashed}")
        say("services", mode=mode, events=ingested, sync_s=f"{secs:.4f}",
            requests=stats["total_requests"], locked=locked,
            fulfilled=stats["total_fulfilled"],
            volume=stats["total_volume"], api_stats="equal",
            provers=json.dumps(svc.provers()).replace(" ", ""),
            indexer="equal", slashed=0)


KERNELS = (
    ("poseidon2_sponge", "boundless_tpu_torch/csrc/poseidon2.cu",
     "boundless_tpu/core/poseidon2_pallas.py:358"),
    ("ntt_sub_transform", "boundless_tpu_torch/csrc/ntt.cu",
     "boundless_tpu/core/ntt_pallas.py:65"),
    ("cons_eval", "boundless_tpu_torch/kernels/cons.py",
     "boundless_tpu/air/pallas_eval.py:380"),
    ("p254_sponge", "boundless_tpu_torch/csrc/poseidon254.cu",
     "boundless_tpu/core/poseidon_bn254.py:189 hash_rows_np and :198 "
     "hash_pairs_np (host)"),
    ("bn254_msm", "boundless_tpu_torch/csrc/msm.cu",
     "boundless_tpu/groth16/msm_tpu.py:237"),
    ("bb_weighted_sum", "boundless_tpu_torch/csrc/bbmm.cu",
     "boundless_tpu/core/bbmm.py:108"),
    ("trace_upload", "boundless_tpu_torch/csrc/upload.cu",
     "none: the host's boundless_tpu/core/field.py mont_np"),
)


def timed_phase(name: str, fn):
    """Run one phase and print its host seconds."""
    t0 = time.perf_counter()
    out = fn()
    say(name, phase_seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def main():
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    sm_clocks_per_s = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    lat = phase_probe(dev, sm_clocks_per_s)
    stats = {"poseidon2_sponge": phase_kernel_sponge(dev, sm_clocks_per_s,
                                                     lat),
             "ntt_sub_transform": phase_kernel_ntt(dev, sm_clocks_per_s)}
    stats["bb_weighted_sum"], bbmm_plain_checks = phase_kernel_bbmm(
        dev, sm_clocks_per_s)
    stats["trace_upload"] = timed_phase("upload", lambda: phase_upload(dev))
    cons_check = Checker()
    phase_golden(dev, cons_check)
    launches, stats["cons_eval"], main_witness = phase_main(
        dev, cons_check, sm_clocks_per_s)
    wide_launches = timed_phase("wide", lambda: phase_wide(dev))
    audit_launches = timed_phase("audit", lambda: phase_audit(dev))
    timed_phase("debug", lambda: phase_debug(dev, main_witness))
    mesh_launches = timed_phase("mesh", lambda: phase_mesh(dev))
    phase_recursion_kernels(dev, sm_clocks_per_s, lat)
    rec_launches, rec_system, rec_session = phase_recursion(dev)
    povw_launches = timed_phase("povw", lambda: phase_povw(rec_system,
                                                           rec_session))
    phase_coproc_kernels(dev, sm_clocks_per_s, lat)
    coproc_launches, coproc_system = phase_coproc(dev, cons_check)
    cluster_launches = timed_phase("cluster", lambda: phase_cluster(
        dev, rec_system, coproc_system))
    market_launches, market_chains = timed_phase(
        "market", lambda: phase_market(dev))
    timed_phase("services", lambda: phase_services(market_chains))
    stats["p254_sponge"] = timed_phase("p254", lambda: phase_kernel_p254(
        dev, sm_clocks_per_s, lat))
    stats["bn254_msm"] = timed_phase("msm", lambda: phase_kernel_msm(
        dev, sm_clocks_per_s, lat))
    g16_launches = timed_phase("groth16", lambda: phase_groth16(dev))
    wrap_launches = timed_phase("wrap", lambda: phase_wrap(dev))
    # each kernel's launches on its own path: the main path for the
    # segment prover's four, [wrap] for the p254 sponge, [groth16] for
    # the MSM (the CI wrap takes the trapdoor prover)
    launches["p254_sponge"] = wrap_launches["p254_sponge"]
    launches["bn254_msm"] = g16_launches["bn254_msm"]
    check_bbmm_paths(bbmm_plain_checks)
    idle = [p for p, c in (("main", launches), ("mesh", mesh_launches),
                           ("recursion", rec_launches),
                           ("coproc", coproc_launches),
                           ("cluster", cluster_launches),
                           ("market", market_launches),
                           ("wrap", wrap_launches))
            if c.get("bb_weighted_sum", 0) <= 0]
    if idle:
        raise AssertionError(f"the weighted-sum kernel did not launch on "
                             f"{idle}")
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name],
         "launches_rv32im_po2_20": wide_launches.get(name, 0),
         "launches_audit": audit_launches[name],
         "launches_mesh": mesh_launches[name],
         "launches_recursion": rec_launches.get(name, 0),
         "launches_povw": povw_launches[name],
         "launches_coproc": coproc_launches.get(name, 0),
         "launches_cluster": cluster_launches.get(name, 0),
         "launches_market": market_launches.get(name, 0),
         "launches_groth16": g16_launches[name],
         "launches_wrap": wrap_launches[name],
         **stats[name], "library_ms": None}
        for name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
