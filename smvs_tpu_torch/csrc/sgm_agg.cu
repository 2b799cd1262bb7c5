// SGM path-cost aggregation on Hopper (sm_90a), bound with ctypes from
// smvs_tpu_torch/sgm/cuda_agg.py. Five kernels.
//
// They replace the five TPU kernels of smvs_tpu/sgm/pallas_agg.py:
//   1. _fused_kernel, reached through _fused_pass (pallas_agg.py:137-194,
//      call at :288): one forward or reverse sweep of 1 path (straight) or
//      3 paths (straight and both diagonals) added into an accumulator;
//   2. _fused_kernel_batch, reached through _fused_pass_batch
//      (pallas_agg.py:413-452, call at :488): the same sweep over B problems;
//   3. _fused_kernel_bidir, reached through _fused_pass_bidir
//      (pallas_agg.py:302-402, call at :389): the forward and the backward
//      sweep in one walk, returning acc + forward + backward;
//   4. _fused_kernel_loop, reached through _fused_pass(loop=True)
//      (pallas_agg.py:197-235, call at :288): row 1's result in fori_loop
//      form;
//   5. _scan_kernel, reached through scan_direction (pallas_agg.py:40-117,
//      call at :99): one path in one direction over an int32 [L, X, D]
//      volume scanned along axis 1, written out (not accumulated).
// Which kernel serves a call is chosen from its shape by
// cuda_agg.plan_route:
// - sgm_line_kernel: every straight-only sweep of rows 2 and 3 up to 512
//   depths (the horizontal sweeps of aggregate_batch and aggregate, and
//   fused_pass_batch / fused_pass_bidir with shifts (0,));
// - sgm_sweep3_kernel: rows 1 and 4, and every sweep of rows 2 and 3
//   with distinct shifts that include a diagonal, up to 512 depths, whose
//   problem fits the resident blocks (the vertical sweeps of
//   aggregate_batch and aggregate); its two-walk form (kBidir) takes row
//   3's vertical pair, both directions in one launch, at D <= 128 (the
//   vertical sweeps of aggregate, and fused_pass_bidir);
// - sgm_path_kernel: row 5, and one launch per path of a sweep that the
//   other two cannot take (a repeated shift, in any row; or a problem
//   wider than the resident blocks of sgm_sweep3_kernel), up to 512
//   depths; it is the line kernel's design walking a chain;
// - sgm_deep_sweep_kernel: every sweep of distinct shifts at more than 512
//   depths (up to 16384), one launch per sweep: a straight-only sweep over
//   any number of problems, one with a diagonal per chunk of problems
//   whose lines the card holds at once;
// - sgm_deep_kernel: the rest beyond 512 depths, one launch per path, as
//   sgm_path_kernel takes them below (a repeated shift, a problem whose
//   lines the card cannot hold at once, row 5).
//
// Recurrence, per line and depth d (int32 arithmetic):
//   new[d] = cost[d] + min(prev[d], prev[d-1] + P1, prev[d+1] + P1,
//                          min(prev) + P2a) - min(prev)
//   P2a    = max(P1*3/2, P2 / (|I(pos) - I(prev pos on the path)| + 1))
// A path restarts from the raw cost at the start of the scan and, for a
// diagonal, where it enters through the border line.
//
// Every kernel holds the D depths of a line in registers across the 32
// lanes of a warp (K = ceil(D/32) per lane, 4 at D = 128). The line,
// sweep and path kernels are built for K = 1-4, 8 and 16 (D <= 128, 256
// and 512); at K = 8 and 16 a lane holds 2 and 4 times the state. prev[d +- 1]
// across lanes come from __shfl_up/down_sync. Depths d >= D hold BIG and
// take no part in a neighbour; costs stay below BIG - P2, so they never
// win a min either. P2a is computed in the kernel from the int32
// intensities of the current and the previous position on the path. Scan,
// line and problem strides are arguments, so a horizontal sweep, and row
// 5's scan along axis 1, need no transposed copy. int16 sums wrap modulo
// 2^16, so the order in which the sweeps add into one accumulator does
// not change its bits: a forward and a backward sweep can run one after
// the other into the same volume.
//
// sgm_line_kernel: one straight sweep (shift 0) of B problems, one warp
// per line, every line an independent chain. Its input accumulator `acc`
// and its output `out` are separate arguments: acc == out adds in place,
// acc != out writes acc + path elsewhere (no copy of acc first), and a
// null acc writes the path cost itself (no zeroed volume, no accumulator
// read). A walk that loads the next position into registers a step ahead
// keeps one position in flight per warp and is paced by load latency,
// about 1.6 us a step against the bytes' 0.66. Here each warp
// (walk_chain, which sgm_path_kernel shares) fills a private ring of
// kLineStages scan positions (cost and accumulator) in shared memory
// kLineStages - 1 steps ahead with cp.async 16-byte pieces (lanes 0-15
// the cost, 16-31 the accumulator at D = 128): 15 positions, 7.5 KB, in
// flight per warp (3.75 KB with no accumulator), 80 to 160 KB per SM at
// the paths' shapes. The ring is private to its
// warp, so __syncwarp orders it and no step waits on a block barrier.
// The int32 intensities are read 32 steps at a time, one per lane, and
// handed out by a shuffle; min(prev) is one redux.sync instruction and
// P2a comes from a table of its 256 values for |dI| < 256 (a division
// above). Depth runs that are not 16-byte aligned (D % 8 != 0, or an odd
// stride) fill the ring with plain loads at K <= 4, and at K = 8 and 16
// with the 4-byte words that cover each run (copy_words), which stay in
// flight as the pieces do. At K = 8 and 16 (129-512 depths) the ring's
// rows hold 32 K depths and it keeps fewer positions, 8 and 4
// (LineRing), so a warp has the same 7-8 KB in flight and a block the
// same 33 KB of shared memory; the step is the same, each depth in DPX
// instructions (sgm_step).
//
// sgm_sweep3_kernel: one cooperative launch per sweep carries the
// straight path and both diagonals at once, so each position's cost and
// accumulator are read once and the accumulator written once for all
// three paths. Block (b, tile) owns kTile consecutive lines of problem b,
// one warp per line, and walks the scan axis:
// - Loads. A ring of kStages scan positions in shared memory is filled by
//   cp.async kStages - 1 steps ahead: each line's cost and accumulator and
//   the tile's intensities (with the line past each end, for the
//   diagonals' P2a). One __syncthreads() per step publishes a stage to the
//   whole block and frees the stage read at the previous step.
// - Inside the block. The straight line stays in the warp's registers. A
//   diagonal's line at step t is read by the next (+1) or the previous
//   (-1) line at step t + 1, so each warp writes its new diagonal lines to
//   a shared buffer indexed by step parity; the same barrier lets its
//   neighbours read them at the next step, and the other parity slot is
//   not written again until every warp has passed it.
// - Across blocks. The warp of the first line writes its -1 line and the
//   warp of the last line its +1 line into a two-slot (parity) edge buffer
//   in device memory, each depth's value in one 64-bit word with the step
//   that wrote it. At the next step those warps read their neighbours'
//   edge lines (at device scope, around L1, which is not coherent across
//   SMs) until every word carries the previous step, and copy them into
//   the shared buffer's end rows. A word read whole holds the value of the
//   step it carries, so the hand-off needs no fence and no flag. Every
//   edge warp reads before it writes within a step and trades in both
//   directions whenever a diagonal runs (a dummy line for an absent one),
//   so a block writes slot t again at step t + 2 only after its neighbour
//   has finished step t + 1, which read it. The waits need every block
//   resident at once: the cooperative launch fails, rather than hangs, if
//   the grid is too large; the wrapper splits B into launches that fit
//   and sends a problem that alone does not fit to sgm_path_kernel.
//   A ragged last tile's idle warps stay in the loop and reach every
//   barrier.
// - At K = 8 and 16 (129-512 depths; Sweep3). A block takes the lines the
//   wrapper plans from L, at most kTile (16 warps, 128 registers a
//   thread): one block an SM and a problem's lines spread over all of
//   them (640 lines: 128 blocks of 5), so every block of a problem is
//   resident and each SM holds the fewest lines. A diagonal line and an
//   edge line are [K][32] words (line_word), so a warp's access of one
//   depth per lane touches 32 consecutive words: no bank conflicts in
//   shared memory, coalesced in device memory. The ring keeps 4 positions
//   at K = 8 and 3 at K = 16, so 16 and 14 lines fit a block (139 and 215
//   KB); 1440 lines (the general path's [1440, 1440, 256]) take 11 a
//   block on 131 SMs. Unaligned runs fill the ring with copy_words, as
//   the line kernel does; each depth's step is sgm_step. The K <= 4
//   instantiations keep kTile lines a block, two blocks an SM and their
//   layout, byte for byte.
// - Both walks (kBidir, K <= 4: row 3's vertical pair). One direction of
//   a [1440, 1440, 128] sweep is 90 blocks of 16 lines and of [640, 640,
//   128] 40, so a pair of one-walk launches leaves 42 and 92 SMs idle
//   for two sweeps' steps. As the Pallas kernel's grid step advances the
//   forward recurrence at x and the backward one at X - 1 - x, a block of
//   the two-walk form owns kBidirMaxLines (8) lines and walks them both
//   ways with 16 warps, so one launch of 180 or 80 blocks takes one
//   sweep's steps. Each walk keeps its own parity buffers, ring rows,
//   intensities and edge slots; the in-place adds of the two walks to one
//   position are ordered by the block's barriers (the kernel's comment
//   says how), so the result is the two one-walk launches' bit for bit.
//
// sgm_path_kernel: one launch per path and direction, one warp per chain
// (a straight chain is a line; a diagonal chain walks (x, l0 + s*k) from
// x = 0 or from the border line), so no two warps share a carried line and
// no warp waits on another. Storage is a template parameter: int16 adding
// into `out` in place (rows 1-3 for a repeated shift and on the
// wide-problem route), int16 writing the path cost (the first launch of
// an 8-path sum on the per-path route), or int32 writing it (row 5, whose
// costs exceed int16). It is sgm_line_kernel's design with a chain's
// addressing: every address of a chain is known in advance (position t
// lies t * (vx + shift * vl) past the first), so both kernels walk their
// chains with walk_chain, a private ring of scan positions filled by
// cp.async S - 1 steps ahead. Its ring is sized in bytes (PathRing, 4 KB
// a warp at every K and element size), its rows padded for an odd
// start's word and filled in 16-byte pieces where every run is aligned
// and otherwise, at every K, with the 4-byte words that cover each run.
// Measured (PERF.md, tools/deep_pace.py --probe-path), what paces it is
// each SM's share of the work, not the ring's depth: a block is one warp,
// so a launch's chains spread evenly over the SMs, and where a lane's run
// is wider than 16 bytes (int16 at K = 16, int32 at K >= 8) the result
// goes out through the ring stage just read, consecutive lanes writing
// consecutive 16-byte pieces, instead of each lane's pieces landing 32 or
// 64 bytes apart.
//
// sgm_deep_kernel: sgm_path_kernel's work for D > 512, where one warp
// would need more than 16 depths a lane (32 would spill), one launch per
// path, one chain a block. A chain's step is a serial dependence, so what
// paces it is the step's latency: the depths a lane, whether the step's
// loads are in shared memory when it starts, and one exchange.
// - Shape (deep_shape). K depths a lane, even, from D: about kDeepWarps
//   (4) warps a chain, K = ceil(D / 128) rounded up to even (6, 8, 16 at
//   D = 513, 1024, 2048), at most 16 and at least what keeps W = ceil(D /
//   (32 K)) <= 32 (16384 depths: 32 warps of 16 a lane). The ceil(D / K)
//   lane runs spread evenly over the W warps (deep_slice: at D = 513
//   174 + 174 + 165 depths), so no warp holds a stub; a warp's lanes past
//   its runs, and its depths past D, hold BIG.
// - Loads. Each warp walks its own slice of each position through a
//   private ring of S positions in shared memory (DeepRing: 8 KB of what a
//   step reads below 16 depths a lane, 4 KB at 16, where 8 KB left fewer
//   blocks resident than a launch's chains; 10 positions at D = 513 in
//   int32, 2 at 2048), filled S - 1 steps ahead as walk_chain fills its
//   ring, so that odd D and odd starts keep positions in flight too. An
//   int16 ring takes the 16-byte pieces that cover the slice from the
//   boundary at or below it (fill_cover; a piece past the volume's end is
//   copied an element at a time): the per-path route at D = 513 took 6.4
//   ms against 7.8 with fill_run's 4-byte words, and it puts an in-place
//   accumulator on the output's 16-byte boundaries. An int32 ring takes
//   fill_run's 16-byte pieces where the slice is aligned and else a word
//   an element, which keeps every lane's run aligned in the ring (row 5 at
//   D = 513 10% faster than with the covering pieces). The ring is the
//   warp's own, ordered by __syncwarp. The intensities come 32 steps at a
//   time, one a lane, by shuffle; P2a from fill_p2a's table.
// - Exchange. Each step, each warp publishes its line's minimum (one
//   redux.sync) and its first and last depth to [parity][warp] slots; one
//   block barrier (kDeepBarrier: __syncthreads or the named barrier of the
//   chain's threads) later, every warp reads the block's min(prev) (lane i
//   warp i's, one redux.sync) and the depths next to its slice from its
//   neighbours. A slot is written again two steps later, after the barrier
//   that every reader of it has passed; it is the loop's only block
//   barrier, and every warp of a block walks the same chain, so all reach
//   it.
// - Stores. Where a lane's run is wider than 16 bytes (int32 at K > 4,
//   int16 at K > 8), the result goes out through the ring stage just read,
//   placed so that the run's 16-byte boundaries fall on the row's, and the
//   lanes write consecutive 16-byte pieces (the run's ends element by
//   element), adding an in-place accumulator from its ring row on the way
//   (one SIMD add a word); otherwise each lane writes its run in the
//   widest pieces its size allows (RunPiece). Staging the 12-byte int16
//   runs of D = 513 too was slower (7.9 ms against 6.5 for the per-path
//   route, PERF.md). In place (rows 1-3), a warp reads each
//   position of its slice into its ring before it writes it, and no other
//   warp writes that slice.
// - Registers. At K = 16 a block may have 1024 threads (64 registers a
//   thread); below, at most kDeepWarps warps (deep_max_warps). The line is
//   updated in place and int16 costs stay two to a register (RunRegs), so
//   no form spills (ptxas, PERF.md). The recurrence and its integer
//   arithmetic are the other kernels', bit for bit (sgm_step).

// sgm_deep_sweep_kernel: one launch per sweep beyond 512 depths carries
// every distinct shift of the sweep, as the Pallas kernel's pass does, so
// a sweep reads the cost and the accumulator once and writes once: 4
// sweeps (11 volumes) for an 8-path sum instead of 8 launches (23). The
// facts that bound it: a diagonal's line moves to the neighbouring line at
// every step, so all lines of a problem must be resident at once, and at
// [640, 640, 2048] the three paths' state is 15.7 MB, about 5 lines an SM.
// - Threads. A line is walked by G = 32 W threads of K depths each (K
//   even; deep_sweep_shape): K = ceil(D / 128) rounded up to even (6 to
//   16) with a diagonal, so a line has about 4 warps and no warp a single
//   depth (D = 513: 192 + 192 + 129); straight only, W = ceil(D / 512).
//   Block (b, tile) owns `lines` consecutive lines of problem b, at most
//   kDeepSweepDiagThreads threads with a diagonal (96 registers a thread).
// - State. The straight line stays in registers (prev_s). The diagonal
//   lines live in shared memory by step parity, [K][G] ints per line so
//   consecutive threads touch consecutive words: row r reads row r - 1's
//   +1 line and row r + 1's -1 line of step t - 1 and writes its own of
//   step t, so one __syncthreads() a step is enough. Each warp's minimum
//   of each path, and the straight line's first and last depth per warp,
//   go to small parity buffers for the next step's min(prev) and the
//   depths past a warp's ends.
// - Loads. The cost comes through a ring in shared memory by cp.async (2
//   stages with a diagonal, a step ahead; 4 straight only): 16-byte
//   pieces where every depth run is 16-byte aligned, otherwise the 4-byte
//   words that cover the run, starting one element early where the run
//   starts on an odd element (the cost is read-only, so these copies may
//   go through L1). Loading the cost into registers a step ahead instead
//   was 2-3x slower, and 3 stages no faster. The accumulator is read at
//   the step's start, in 16-, 8- or 4-byte pieces where aligned (2 bytes
//   at odd D), and the result written in the same pieces.
// - Across blocks. A launch with a diagonal is cooperative and holds at
//   most one block per SM (cuda_agg.plan_route). The first row's +1 line
//   and the last row's -1 line come from the neighbouring blocks, through
//   tagged 64-bit words in device memory as sgm_sweep3_kernel's edges:
//   [K][G] values then the W warps' minima, by step % 4. An edge row
//   whose outgoing diagonal comes from another row of its block computes
//   and publishes it first; every edge row then copies the incoming
//   line's words it reads into shared memory with cp.async (no registers
//   held; into the rows of the parity buffer that nobody in the block
//   reads: the first row's -1 line and the last row's +1 line), and
//   checks each word's tag as it uses it, reading a stale word again at
//   device scope. Four slots make the early publish safe: before a block
//   writes slot s + 4 it has read its neighbour's words of step s + 2,
//   which the neighbour published after reading slot s. A wait that lasts
//   seconds traps (kPollLimit), so a fault fails the launch.
// - Straight only: no hand-off; any grid (one line a block), 4 stages.
// Measured (PERF.md, tools/deep_pace.py): the straight sweeps reach
// 60-80% of their bytes at D = 1024 and 2048; a sweep with a diagonal
// takes 4.6-9.7 us a step at D = 513-2048, paced by the step's work
// inside a block (a dependent chain per path and one barrier, 10-20 warps
// an SM) and the edge rows' round trip, not by the bytes; ptxas gives it
// 96 registers a thread and spills 70-210 bytes at 14-16 depths a lane.
//
// Bounds on the H100 (3.35 TB/s). A sweep must read the cost once, read
// the accumulator once if there is one and write the result once, and
// read the int32 intensities once. sgm_line_kernel at the main path's
// horizontal sweep, B=2 x 1440 lines x 1696 steps x 128 int16: 3 x the
// volume with an accumulator (3.75 GB, 1.126 ms), 2 x without one (2.50
// GB, 0.751 ms). sgm_sweep3_kernel's vertical sweep at the same shape
// also 1.126 ms (0.563 ms for one problem); one launch per path would
// move those bytes three times. NVIDIA's data sheet gives no peak rate for
// integer min and add work, so the bound is the bytes. That work is of
// the same order: about 3 instructions per element and path in Hopper's
// 16x2 DPX forms, 16 G for the 8 paths of aggregate_batch, 0.5 to 1 ms at
// one or two per int32 lane and clock; these kernels issue about 10 int32
// instructions per element and path. Measured (PERF.md,
// tools/sweep_pace.py), the sweep kernel is paced neither by the bytes
// nor by the hand-off but by the work of one step inside a block: a
// dependent chain per path and a barrier, with 16 warps per SM; a deeper
// ring does not help there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 1 << 24;
// Lines (one warp each) per sweep block: every block's at K <= 4, the most
// a block holds at K = 8 and 16 (Sweep3).
constexpr int kTile = 16;
constexpr int kEdge = 128;          // words per edge line at K <= 4
// Lines a block of the sweep kernel's two-walk form holds (kBidir, K <=
// 4): each line is walked by two warps, so at most kTile warps a block.
constexpr int kBidirMaxLines = kTile / 2;
// Depths the line, sweep and path kernels take (32 lanes x K <= 16).
constexpr int kPathMaxD = 512;
constexpr int kSweepMaxD = 128;     // K <= 4: the main path's instantiations
// The deep kernels: at most kDeepMaxWarps warps a chain of at most
// kPathMaxD depths each (16 a lane), so at most kDeepMaxD depths.
constexpr int kDeepMaxWarps = 32;
constexpr int kDeepMaxD = kPathMaxD * kDeepMaxWarps;
// sgm_deep_kernel: about how many warps walk a chain (deep_shape chooses
// the depths a lane from it and D); the bytes of what a step reads that a
// warp's ring keeps in flight below 16 depths a lane and at 16 (DeepRing);
// whether a lane's result goes out through the ring stage just read, as
// consecutive 16-byte pieces (0: never, 1: where a lane's run is wider
// than 16 bytes, 2: also where it is not one aligned piece of 4, 8 or 16
// bytes); how a warp fills its ring (0: fill_run, 16-byte
// pieces where the slice is aligned, else 4-byte words; 1: the 16-byte
// pieces that cover the slice, from the boundary at or below it; 2: 1 for
// int16, 0 for int32); and the step's barrier (0: __syncthreads, 1: the
// named barrier 1 of the chain's W * 32 threads). tools/deep_pace.py
// --probe-deep builds other values with -D and times them (PERF.md).
#ifndef SGM_DEEP_WARPS
#define SGM_DEEP_WARPS 4
#endif
#ifndef SGM_DEEP_RING_BYTES
#define SGM_DEEP_RING_BYTES 8192
#endif
#ifndef SGM_DEEP_RING_BYTES_16
#define SGM_DEEP_RING_BYTES_16 4096
#endif
#ifndef SGM_DEEP_STAGE_OUT
#define SGM_DEEP_STAGE_OUT 1
#endif
#ifndef SGM_DEEP_FILL
#define SGM_DEEP_FILL 2
#endif
#ifndef SGM_DEEP_BARRIER
#define SGM_DEEP_BARRIER 0
#endif
constexpr int kDeepWarps = SGM_DEEP_WARPS;
constexpr int kDeepRingBytes = SGM_DEEP_RING_BYTES;
constexpr int kDeepRingBytes16 = SGM_DEEP_RING_BYTES_16;
constexpr int kDeepStageOut = SGM_DEEP_STAGE_OUT;
constexpr int kDeepFill = SGM_DEEP_FILL;
constexpr int kDeepBarrier = SGM_DEEP_BARRIER;
// sgm_line_kernel and sgm_path_kernel: warps (one chain each) per block;
// sgm_line_kernel: scan positions in a warp's ring (sgm_path_kernel sizes
// its ring in bytes, PathRing). Small blocks balance the SMs: the main
// path's horizontal sweep (B = 2 x 1440 lines) is 720 blocks, at most 6 per SM
// against 5.45 on average, and every block is resident at once (each
// takes 33 KB of shared memory, 128 threads and 64 registers a thread, so
// 6 fit an SM by shared memory, 8 by registers, 16 by threads: 792 on
// the card). tools/line_pace.py builds other ring depths with
// -DSGM_LINE_STAGES=n and times them: 16 positions beat 8 by 6% on the
// write launch and by 9% at B = 1, and tie 4 over the main path's two
// horizontal launches (PERF.md).
constexpr int kChainWarps = 4;
#ifndef SGM_LINE_STAGES
#define SGM_LINE_STAGES 16
#endif
constexpr int kLineStages = SGM_LINE_STAGES;
// sgm_path_kernel: warps (one chain each) per block; the bytes of what a
// step reads that a warp's ring keeps in flight (PathRing); and whether a
// lane's run wider than 16 bytes is written through the ring stage just
// read, as consecutive 16-byte pieces. tools/deep_pace.py --probe-path
// builds other values with -D and times them (PERF.md): one warp a block
// spreads a launch's chains evenly over the SMs (640 chains in blocks of
// 4 leave 28 SMs twice the warps of the rest), and 4 KB a warp keeps the
// 2880 chains of a main-path-sized sweep resident at once (32 blocks an
// SM), as deep as 8 or 32 KB elsewhere; staged writes took row 5 at
// [640, 640, 512] from 1.28 to 0.86 ms.
#ifndef SGM_PATH_WARPS
#define SGM_PATH_WARPS 1
#endif
#ifndef SGM_PATH_RING_BYTES
#define SGM_PATH_RING_BYTES 4096
#endif
#ifndef SGM_PATH_STAGE_OUT
#define SGM_PATH_STAGE_OUT 1
#endif
constexpr int kPathWarps = SGM_PATH_WARPS;
constexpr int kPathRingBytes = SGM_PATH_RING_BYTES;
constexpr bool kPathStageOut = SGM_PATH_STAGE_OUT != 0;
constexpr unsigned kFull = 0xffffffffu;

// sgm_line_kernel's ring by depths a lane: rows of 128 depths and
// kLineStages positions at K <= 4; beyond, rows of 32 K depths and the
// word an odd start adds (copy_words), padded to 16 bytes, and
// kLineStages * 4 / K positions (8 at K = 8, 4 at K = 16), so that a warp
// keeps the same bytes in flight (8 KB of cost and accumulator) and a
// block about the same 33 KB of shared memory at every D.
template <int K>
struct LineRing {
  static constexpr int kRow = K <= 4 ? 128 : 32 * K + 8;
  static constexpr int kStages =
      K <= 4 ? kLineStages
             : (kLineStages * 4 / K > 2 ? kLineStages * 4 / K : 2);
};

// sgm_sweep3_kernel by depths a lane. K <= 4 (the main path): every block
// holds kTile lines, two blocks an SM, a ring of 4 positions. K = 8 and 16:
// a block holds up to kTile lines, as many as the wrapper plans from L
// (cuda_agg.deep_sweep_chunks: one block an SM, a problem's lines spread
// over all SMs), and the ring 4 or 3 positions, so that 16 lines at K = 8
// (139 KB) and 14 at K = 16 (215 KB) fit a block's shared memory.
template <int K>
struct Sweep3 {
  static constexpr bool kFixed = K <= 4;
  static constexpr int kStages = K <= 8 ? 4 : 3;
  static constexpr int kMinBlocks = kFixed ? 2 : 1;
  // Words of one edge line in device memory: 128 at K <= 4, 32 K beyond.
  static constexpr int kEdgeWords = kFixed ? kEdge : 32 * K;
};

// One depth of the recurrence, c + min(prev, min(dn, up) + P1, m + P2a) - m
// in int32 (mp = m + P2a); the adds and the minima fuse into Hopper's DPX
// instructions, which are exact.
__device__ __forceinline__ int sgm_step(int c, int prev, int dn, int up,
                                        int p1, int mp, int m) {
  return __vimin3_s32(prev, dn + p1, __viaddmin_s32(up, p1, mp)) + (c - m);
}

// Loads depths [d0, d0 + K) of one position; depths >= D read as 0.
// vec: the whole run is aligned to sizeof(T) * K bytes (at most 16 bytes
// used per access).
template <typename T, int K>
__device__ __forceinline__ void load_k(const T* p, int (&v)[K], int d0, int D,
                                       bool vec) {
  if (vec && d0 + K <= D) {
    if constexpr (sizeof(T) == 2 && K == 4) {
      const short4 s = *reinterpret_cast<const short4*>(p);
      v[0] = s.x;
      v[1] = s.y;
      v[2] = s.z;
      v[3] = s.w;
      return;
    } else if constexpr (sizeof(T) == 2 && K == 2) {
      const short2 s = *reinterpret_cast<const short2*>(p);
      v[0] = s.x;
      v[1] = s.y;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 4) {
      const int4 s = *reinterpret_cast<const int4*>(p);
      v[0] = s.x;
      v[1] = s.y;
      v[2] = s.z;
      v[3] = s.w;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 2) {
      const int2 s = *reinterpret_cast<const int2*>(p);
      v[0] = s.x;
      v[1] = s.y;
      return;
    } else if constexpr ((sizeof(T) * K) % 16 == 0) {
      // K = 8 or 16 (D > 128): 16-byte pieces of 16 / sizeof(T) depths.
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int c = 0; c < K / kPer; ++c) {
        const int4 s = reinterpret_cast<const int4*>(p)[c];
        const T* e = reinterpret_cast<const T*>(&s);
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[c * kPer + j] = static_cast<int>(e[j]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = (d0 + k < D) ? static_cast<int>(p[k]) : 0;
}

// Stores depths [d0, d0 + K) of one position; depths >= D are skipped.
template <typename T, int K>
__device__ __forceinline__ void store_k(T* p, const int (&v)[K], int d0, int D,
                                        bool vec) {
  if (vec && d0 + K <= D) {
    if constexpr (sizeof(T) == 2 && K == 4) {
      short4 s;
      s.x = static_cast<short>(v[0]);
      s.y = static_cast<short>(v[1]);
      s.z = static_cast<short>(v[2]);
      s.w = static_cast<short>(v[3]);
      *reinterpret_cast<short4*>(p) = s;
      return;
    } else if constexpr (sizeof(T) == 2 && K == 2) {
      short2 s;
      s.x = static_cast<short>(v[0]);
      s.y = static_cast<short>(v[1]);
      *reinterpret_cast<short2*>(p) = s;
      return;
    } else if constexpr (sizeof(T) == 4 && K == 4) {
      *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (sizeof(T) == 4 && K == 2) {
      *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
      return;
    } else if constexpr ((sizeof(T) * K) % 16 == 0) {
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll
      for (int c = 0; c < K / kPer; ++c) {
        int4 s;
        T* e = reinterpret_cast<T*>(&s);
#pragma unroll
        for (int j = 0; j < kPer; ++j) e[j] = static_cast<T>(v[c * kPer + j]);
        reinterpret_cast<int4*>(p)[c] = s;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (d0 + k < D) p[k] = static_cast<T>(v[k]);
}

// One step of the recurrence for depths [d0, d0 + K) of a line:
// nv = cur + min(prev, prev[d+-1] + P1, min(prev) + P2a) - min(prev).
// kRedux: min(prev) across the warp in one redux.sync instruction instead
// of a shuffle butterfly (the line and sweep kernels), and at K >= 8 each
// depth in DPX instructions (sgm_step), the same int32 result.
template <int K, bool kRedux = false>
__device__ __forceinline__ void min_plus(const int (&prev)[K],
                                         const int (&cur)[K], int lane,
                                         int p1, int p2a, int (&nv)[K]) {
  int m = prev[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, prev[k]);
  if constexpr (kRedux) {
    m = __reduce_min_sync(kFull, m);
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
  }
  int left = __shfl_up_sync(kFull, prev[K - 1], 1);    // prev[d0 - 1]
  int right = __shfl_down_sync(kFull, prev[0], 1);     // prev[d0 + K]
  if (lane == 0) left = kBig;
  if (lane == 31) right = kBig;
  const int mp = m + p2a;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dn = k == 0 ? left : prev[k - 1];
    const int up = k == K - 1 ? right : prev[k + 1];
    if constexpr (kRedux && K >= 8) {
      nv[k] = sgm_step(cur[k], prev[k], dn, up, p1, mp, m);
    } else {
      const int upd = min(min(prev[k], min(up, dn) + p1), mp);
      nv[k] = cur[k] + upd - m;
    }
  }
}

// Depths [d0, d0 + K) of a carried line in shared memory.
template <int K>
__device__ __forceinline__ void load_line(const int* p, int (&v)[K]) {
  if constexpr (K == 4) {
    const int4 s = *reinterpret_cast<const int4*>(p);
    v[0] = s.x;
    v[1] = s.y;
    v[2] = s.z;
    v[3] = s.w;
  } else if constexpr (K == 2) {
    const int2 s = *reinterpret_cast<const int2*>(p);
    v[0] = s.x;
    v[1] = s.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

template <int K>
__device__ __forceinline__ void store_line(int* p, const int (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// Word k of `lane`'s depths in a line of 32 K words: a lane's run of K
// (K <= 4: one vector access a lane), or [K][32] (K >= 8: one warp access
// per k touches 32 consecutive words, free of bank conflicts in shared
// memory and coalesced in device memory).
template <int K>
__device__ __forceinline__ int line_word(int lane, int k) {
  return K >= 8 ? k * 32 + lane : lane * K + k;
}

// A carried line of a sweep block's shared memory, at row `row`.
template <int K>
__device__ __forceinline__ void get_line(const int* row, int lane,
                                         int (&v)[K]) {
  if constexpr (K >= 8) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = row[line_word<K>(lane, k)];
  } else {
    load_line<K>(row + lane * K, v);
  }
}

template <int K>
__device__ __forceinline__ void put_line(int* row, int lane,
                                         const int (&v)[K]) {
  if constexpr (K >= 8) {
#pragma unroll
    for (int k = 0; k < K; ++k) row[line_word<K>(lane, k)] = v[k];
  } else {
    store_line<K>(row + lane * K, v);
  }
}

// An edge line in device memory holds each depth's value with the scan
// step that wrote it in one 64-bit word (step << 32 | value), written and
// read whole at device scope, so a reader that sees the step it waits for
// has the value of that step: no fence and no separate flag.
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// This lane's depths of the edge line at `p`, tagged with `step`.
template <int K>
__device__ __forceinline__ void publish_edge(unsigned long long* p, int lane,
                                             unsigned step,
                                             const int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    store_relaxed(p + line_word<K>(lane, k),
                  static_cast<unsigned long long>(step) << 32 |
                      static_cast<unsigned>(v[k]));
}

// Reads this lane's depths of the edge line at `p` until the whole warp
// sees them all tagged with `step`.
template <int K>
__device__ __forceinline__ void poll_edge(const unsigned long long* p,
                                          int lane, unsigned step,
                                          int (&v)[K]) {
  bool ok;
  do {
    ok = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned long long e = load_relaxed(p + line_word<K>(lane, k));
      v[k] = static_cast<int>(static_cast<unsigned>(e));
      ok = ok && static_cast<unsigned>(e >> 32) == step;
    }
  } while (!__all_sync(kFull, ok));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 1 where an int16 run starts on the odd element of a 4-byte word.
__device__ __forceinline__ int odd_start(const int16_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
}

// A depth run that is not 16-byte aligned, into a ring row at K >= 8: the
// 4-byte words that cover its n = D + odd_start elements from src, the
// word-aligned address one element before an odd start, by cp.async
// (lanes take words in turn), so that the loads stay in flight as the
// aligned runs' 16-byte pieces do; the row then holds the run from
// element odd_start. A word that would pass `end`, the end of the launch's
// volume, is copied as its first element alone.
__device__ __forceinline__ void copy_words(int16_t* dst, const int16_t* src,
                                           int n, const int16_t* end,
                                           int lane) {
  for (int c = lane; 2 * c < n; c += 32) {
    if (src + 2 * c + 2 <= end)
      cp_async4(dst + 2 * c, src + 2 * c);
    else
      dst[2 * c] = src[2 * c];
  }
}

// Shared memory of a sweep block of `lines` lines (byte offsets), K depths
// a lane, S ring stages and `walks` walks (1, or 2 for the form that walks
// both scan directions): the new diagonal lines by step parity, int32
// [walk][parity][+1, -1][lines + 2][32 K] (row w + 1 is the walk's warp
// w's line; rows 0 and lines + 1 hold the neighbouring blocks' edge lines,
// which the edge warps copy in); a ring of S scan positions, int16
// [S][walk][lines][cost, acc][ring_row]: 32 K depths, and at K >= 8 the
// word that copy_words adds at an odd start, padded to 16 bytes (32 K +
// 8); the intensities of the block's lines and the one line past each end,
// int32 [S][walk][lines + 2]; P2a by |dI| below 256. At K <= 4, kTile
// lines and one walk this is the main path's layout, byte for byte. The
// plan mirrors it (cuda_agg.sweep_smem_bytes).
struct Sweep3Layout {
  int diag, line, inten, p2a, bytes;
};

__host__ __device__ inline int sweep3_ring_row(int K) {
  return K <= 4 ? 32 * K : 32 * K + 8;
}

__host__ __device__ inline Sweep3Layout sweep3_layout(int lines, int K,
                                                      int S, int walks = 1) {
  const int row = 32 * K;
  Sweep3Layout s;
  s.diag = 0;
  s.line = walks * 2 * 2 * (lines + 2) * row * 4;
  s.inten = s.line + S * walks * lines * 2 * sweep3_ring_row(K) * 2;
  s.p2a = s.inten + S * walks * (lines + 2) * 4;
  s.bytes = s.p2a + 256 * 4;
  return s;
}

// One sweep of the paths selected by `paths` (bit 0: straight, bit 1: +1,
// bit 2: -1) over B int16 problems, out += paths in place. Block
// (b, tile) owns lines [tile * lines, tile * lines + lines) of problem b,
// warp w line tile * lines + w, where lines is kTile at K <= 4 and
// `lines_arg` (<= kTile) beyond. edge: [B, tiles, parity, (+1, -1),
// Sweep3<K>::kEdgeWords] tagged words, all -1 before the launch. async16:
// every line's depth run is 16-byte aligned and D % 8 == 0, so the ring is
// filled by cp.async in 16-byte pieces; otherwise by plain loads.
//
// kBidir (K <= 4; Pallas row 3's vertical pair): the forward and the
// backward sweep in one launch, `reverse` not read. A block owns
// `lines_arg` (<= kBidirMaxLines) lines in both walks: warps [0, lines)
// walk them forward, warps [lines, 2 lines) backward, and at step s the
// forward walk is at position s, the backward one at X - 1 - s. Each walk
// has its own parity buffers, ring rows, intensities and edge slots (edge:
// [B, tiles, walk, parity, (+1, -1), kEdgeWords]); the walks share the
// block's one barrier a step. Both add into `out` in place: position p is
// visited at steps p and X - 1 - p, g = |X - 1 - 2p| steps apart, and the
// ring reads out[p] for the second visit S - 1 steps before it. So where
// 0 < g < S the second visit reads out[p] itself, after the barrier that
// follows the first visit's store, and its ring stage takes the cost
// alone; at g = 0 (X odd: the middle position, at the middle step) the
// backward walk adds after a second barrier that follows the forward
// walk's store. int16 sums wrap, so the adds' order does not change the
// bits; what matters is that no two of them overlap.
template <int K, bool kBidir = false>
__global__ void __launch_bounds__(kTile * 32, Sweep3<K>::kMinBlocks)
    sgm_sweep3_kernel(const int16_t* __restrict__ cost,
                      const int32_t* __restrict__ inten,
                      int16_t* __restrict__ out,
                      unsigned long long* __restrict__ edge, int X, int L,
                      int D, long long vb, long long vx, long long vl,
                      long long ib, long long ix, long long il, int reverse,
                      int paths, int p1, int p2, bool vec, bool async16,
                      int lines_arg) {
  static_assert(!kBidir || Sweep3<K>::kFixed, "both walks at K <= 4 only");
  constexpr int S = Sweep3<K>::kStages;
  constexpr int kRow = 32 * K;
  constexpr int kWalks = kBidir ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lines = Sweep3<K>::kFixed && !kBidir ? kTile : lines_arg;
  const Sweep3Layout lay = sweep3_layout(lines, K, S, kWalks);
  int* s_diag = reinterpret_cast<int*>(smem_raw + lay.diag);
  int16_t* s_line = reinterpret_cast<int16_t*>(smem_raw + lay.line);
  int* s_inten = reinterpret_cast<int*>(smem_raw + lay.inten);
  int* s_p2a = reinterpret_cast<int*>(smem_raw + lay.p2a);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // This warp's walk (1: the backward one of a kBidir block), its line in
  // the tile, and its direction.
  const int walk = kBidir && w >= lines ? 1 : 0;
  const int lw = w - walk * lines;
  const int rev = kBidir ? walk : reverse;
  // [walk][parity][+1, -1][row][d], [stage][walk, warp][cost, acc][d],
  // [stage][walk][line]
  auto diag_row = [&](int par, int dir, int row) {
    return s_diag + (((walk * 2 + par) * 2 + dir) * (lines + 2) + row) * kRow;
  };
  auto ring = [&](int q, int warp, int which) {
    return s_line +
           ((q * kWalks * lines + warp) * 2 + which) * sweep3_ring_row(K);
  };
  auto inten_at = [&](int q, int i) {
    return s_inten + (q * kWalks + walk) * (lines + 2) + i;
  };
  const int tiles = (L + lines - 1) / lines;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int l = tile * lines + lw;
  const bool active = l < L;
  const int last = min(lines, L - tile * lines) - 1;  // warp of the last line
  const bool straight = paths & 1, plus = paths & 2, minus = paths & 4;
  const bool diag = plus || minus;
  // The edge warps trade with the neighbouring blocks whenever a diagonal
  // runs, in both directions even if one diagonal is absent: a block reads
  // its neighbour's edge of step t - 1 before it writes its own of step t,
  // so it cannot overwrite a slot (step parity) that the neighbour has not
  // read yet.
  const bool left = diag && lw == 0 && tile > 0;
  const bool right = diag && lw == last && tile + 1 < tiles;
  const int d0 = lane * K;
  const int p2min = p1 * 3 / 2;
  const int16_t* cb = cost + b * vb;
  int16_t* ob = out + b * vb;
  const int32_t* ibase = inten + b * ib;
  const long long vend = static_cast<long long>(gridDim.x / tiles) * vb;
  const int16_t* cend = cost + vend;  // the launch's volumes' ends
  const int16_t* oend = out + vend;
  // Edge line (tile, parity, direction 0: +1 of the last line, 1: -1 of
  // the first line) of this warp's walk.
  auto edge_line = [&](int tl, int par, int dir) {
    return edge + (((static_cast<long long>(b) * tiles + tl) * kWalks +
                    walk) * 4 + par * 2 + dir) * Sweep3<K>::kEdgeWords;
  };
  // Whether this warp takes out at step s from out itself, not from its
  // ring: a kBidir walk's second visit of a position 0 < g = 2 s + 1 - X <
  // S steps after the first, and the backward walk's visit of the middle
  // position (g = 0).
  auto from_out = [&](int s) {
    const int g = 2 * s + 1 - X;
    return kBidir && (g > 0 ? g < S : g == 0 && walk == 1);
  };

  // Fill the ring stage of scan step s, S - 1 steps ahead of its use; one
  // copy group per step, empty past the end.
  auto fill = [&](int s) {
    if (s < X) {
      const int q = s % S;
      const int xs = rev ? X - 1 - s : s;
      if (active) {
        const long long go = xs * vx + l * vl;
        int16_t* rc = ring(q, w, 0);
        int16_t* ra = ring(q, w, 1);
        const bool with_acc = !from_out(s);
        if (async16) {
          const int chunks = D / 8;
          for (int c = lane; c < (with_acc ? 2 : 1) * chunks; c += 32) {
            if (c < chunks)
              cp_async16(rc + c * 8, cb + go + c * 8);
            else
              cp_async16(ra + (c - chunks) * 8, ob + go + (c - chunks) * 8);
          }
        } else if constexpr (K >= 8) {
          const int sc = odd_start(cb + go), sa = odd_start(ob + go);
          copy_words(rc, cb + go - sc, D + sc, cend, lane);
          copy_words(ra, ob + go - sa, D + sa, oend, lane);
        } else {
          for (int d = lane; d < D; d += 32) {
            rc[d] = cb[go + d];
            if (with_acc) ra[d] = ob[go + d];
          }
        }
      }
      const int li = tile * lines - 1 + lane;
      if (lw == 0 && lane < lines + 2 && li >= 0 && li < L)
        cp_async4(inten_at(q, lane), ibase + xs * ix + li * il);
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) fill(s);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_p2a[i] = max(p2min, p2 / (i + 1));
  cp_async_wait<S - 2>();
  __syncthreads();
  // P2a of an intensity step; |dI| is the same across the warp.
  auto p2a_of = [&](int i_cur, int i_prev) {
    const int d = abs(i_cur - i_prev);
    return d < 256 ? s_p2a[d] : max(p2min, p2 / (d + 1));
  };

  int prev[K];  // the straight path's line
  // I at the previous position of lines l, l - 1 and l + 1.
  int prev_i = 0, prev_il = 0, prev_ir = 0;
  for (int t = 0; t < X; ++t) {
    fill(t + S - 1);  // into the stage read at step t - 1
    const int q = t % S;
    const int par = t & 1;
    const int pp = par ^ 1;
    // Both walks of a kBidir block at the middle position: the backward
    // walk adds after the forward walk's store.
    const bool middle = kBidir && 2 * t + 1 == X;
    const bool late = middle && walk == 1;
    int16_t* op = ob + (rev ? X - 1 - t : t) * vx + l * vl + d0;
    int av[K];
    if (active) {
      int cur[K], nv[K], nb[K];
      if (t > 0) {  // the neighbours' edge lines of step t - 1
        if (left) {
          poll_edge<K>(edge_line(tile - 1, pp, 0), lane, t - 1, nb);
          put_line<K>(diag_row(pp, 0, 0), lane, nb);
        }
        if (right) {
          poll_edge<K>(edge_line(tile + 1, pp, 1), lane, t - 1, nb);
          put_line<K>(diag_row(pp, 1, lines + 1), lane, nb);
        }
      }
      // Where the ring rows hold the run from (copy_words), and whether
      // this lane's depths there may be read as 16-byte pieces.
      int sc = 0, sa = 0;
      if constexpr (K >= 8) {
        if (!async16) {
          const long long go = (rev ? X - 1 - t : t) * vx + l * vl;
          sc = odd_start(cb + go);
          sa = odd_start(ob + go);
        }
      }
      load_k<int16_t, K>(ring(q, w, 0) + sc + d0, cur, d0, D, sc == 0);
      if (late) {
#pragma unroll
        for (int k = 0; k < K; ++k) av[k] = 0;
      } else if (from_out(t)) {
        load_k<int16_t, K>(op, av, d0, D, vec);
      } else {
        load_k<int16_t, K>(ring(q, w, 1) + sa + d0, av, d0, D, sa == 0);
      }
      const int it = *inten_at(q, lw + 1);
      if (straight) {
        if (t == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) nv[k] = cur[k];
        } else {
          min_plus<K, true>(prev, cur, lane, p1, p2a_of(it, prev_i), nv);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (d0 + k >= D) nv[k] = kBig;
          prev[k] = nv[k];
          av[k] += nv[k];
        }
      }
      if (plus) {  // line l continues line l - 1
        if (t == 0 || l == 0) {  // restart: scan start, or the border line
#pragma unroll
          for (int k = 0; k < K; ++k) nv[k] = cur[k];
        } else {
          get_line<K>(diag_row(pp, 0, lw), lane, nb);  // line l - 1
          min_plus<K, true>(nb, cur, lane, p1, p2a_of(it, prev_il), nv);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (d0 + k >= D) nv[k] = kBig;
          av[k] += nv[k];
        }
        put_line<K>(diag_row(par, 0, lw + 1), lane, nv);
        if (right) publish_edge<K>(edge_line(tile, par, 0), lane, t, nv);
      } else if (right) {
        publish_edge<K>(edge_line(tile, par, 0), lane, t, cur);  // no +1
      }
      if (minus) {  // line l continues line l + 1
        if (t == 0 || l == L - 1) {
#pragma unroll
          for (int k = 0; k < K; ++k) nv[k] = cur[k];
        } else {
          get_line<K>(diag_row(pp, 1, lw + 2), lane, nb);  // line l + 1
          min_plus<K, true>(nb, cur, lane, p1, p2a_of(it, prev_ir), nv);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (d0 + k >= D) nv[k] = kBig;
          av[k] += nv[k];
        }
        put_line<K>(diag_row(par, 1, lw + 1), lane, nv);
        if (left) publish_edge<K>(edge_line(tile, par, 1), lane, t, nv);
      } else if (left) {
        publish_edge<K>(edge_line(tile, par, 1), lane, t, cur);  // no -1
      }
      if (!late) store_k<int16_t, K>(op, av, d0, D, vec);
      prev_i = it;
      prev_il = *inten_at(q, lw);
      prev_ir = *inten_at(q, lw + 2);
    }
    if (middle) {
      __syncthreads();  // after the forward walk's store of the position
      if (active && late) {
        int o[K];
        load_k<int16_t, K>(op, o, d0, D, vec);
#pragma unroll
        for (int k = 0; k < K; ++k) av[k] += o[k];
        store_k<int16_t, K>(op, av, d0, D, vec);
      }
    }
    cp_async_wait<S - 2>();  // this thread's copies for step t + 1
    __syncthreads();
  }
}

// The sweep kernel's shared memory for `lines` lines a block (kTile at
// K <= 4 in one walk), allowed to the kernel.
template <int K, bool kBidir = false>
cudaError_t sweep3_smem(int lines, int* bytes) {
  *bytes = sweep3_layout(lines, K, Sweep3<K>::kStages, kBidir ? 2 : 1).bytes;
  return cudaFuncSetAttribute(sgm_sweep3_kernel<K, kBidir>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

// vec: every lane's depth run of `out` may be written whole (K elements at
// K = 2 and 4, 16-byte pieces where a lane's run is a multiple of 16
// bytes: int16 at K >= 8, int32 at K >= 4).
template <int K, typename T = int16_t>
bool sweep_vec(const void* out, int D, long long vb, long long vx,
               long long vl) {
  if constexpr ((sizeof(T) * K) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
    return D % kPer == 0 && vb % kPer == 0 && vx % kPer == 0 &&
           vl % kPer == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  }
  const uintptr_t align = sizeof(T) * K;
  return (K == 2 || K == 4) && D % K == 0 && vb % K == 0 && vx % K == 0 &&
         vl % K == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
}

template <int K, bool kBidir = false>
cudaError_t launch_sweep3(const void* cost, const void* inten, void* out,
                          void* edge, int B, int X, int L,
                          int D, long long vb, long long vx, long long vl,
                          long long ib, long long ix, long long il,
                          int reverse, int paths, int p1, int p2, int lines,
                          cudaStream_t stream) {
  bool vec = sweep_vec<K>(out, D, vb, vx, vl);
  bool async16 = D % 8 == 0 && vb % 8 == 0 && vx % 8 == 0 && vl % 8 == 0 &&
                 reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (Sweep3<K>::kFixed && !kBidir) lines = kTile;
  int smem = 0;
  const cudaError_t e = sweep3_smem<K, kBidir>(lines, &smem);
  if (e != cudaSuccess) return e;
  const int16_t* c = static_cast<const int16_t*>(cost);
  const int32_t* i = static_cast<const int32_t*>(inten);
  int16_t* o = static_cast<int16_t*>(out);
  unsigned long long* ed = static_cast<unsigned long long*>(edge);
  void* args[] = {&c,  &i,  &o,       &ed,    &X,  &L,  &D,   &vb,
                  &vx, &vl, &ib,      &ix,    &il, &reverse, &paths, &p1,
                  &p2, &vec, &async16, &lines};
  const int tiles = (L + lines - 1) / lines;
  return cudaLaunchCooperativeKernel(
      (const void*)sgm_sweep3_kernel<K, kBidir>,
      dim3(static_cast<unsigned>(B) * tiles),
      dim3((kBidir ? 2 : 1) * lines * 32), args, smem, stream);
}

// Blocks of `lines` lines an SM holds at once.
template <int K, bool kBidir = false>
cudaError_t sweep3_per_sm(int lines, int* per_sm) {
  int smem = 0;
  const cudaError_t e = sweep3_smem<K, kBidir>(lines, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, sgm_sweep3_kernel<K, kBidir>, (kBidir ? 2 : 1) * lines * 32,
      smem);
}

// A depth run of n elements from src into a ring row by cp.async, in
// 4-byte words: at int16 the words that cover it (copy_words), the row then
// holding the run from element odd_start(src); at int32 a word an element.
__device__ __forceinline__ void copy_run(int16_t* dst, const int16_t* src,
                                         int n, const int16_t* end,
                                         int lane) {
  const int sc = odd_start(src);
  copy_words(dst, src - sc, n + sc, end, lane);
}

__device__ __forceinline__ void copy_run(int32_t* dst, const int32_t* src,
                                         int n, const int32_t*, int lane) {
  for (int d = lane; d < n; d += 32) cp_async4(dst + d, src + d);
}

// Where a ring row filled from src holds its run: element odd_start(src)
// where copy_run filled an int16 row (kWords, not async16), else 0.
template <typename T, bool kWords>
__device__ __forceinline__ int ring_start(const T* src, bool async16) {
  if constexpr (kWords && sizeof(T) == 2)
    return async16 ? 0 : odd_start(reinterpret_cast<const int16_t*>(src));
  return 0;
}

// One scan position into a warp's ring rows: the cost's run into rc and,
// where src_a is not null, the accumulator's into ra. async16: every run
// is 16-byte aligned and D a multiple of 16 bytes, so the lanes take the
// 16-byte pieces in turn (int16 at D = 128: lanes 0-15 the cost's, 16-31
// the accumulator's); otherwise, with kWords, the 4-byte words that cover
// each run (copy_run), which stay in flight as the pieces do, and without,
// plain loads. Commits no copy group.
template <typename T, bool kWords>
__device__ __forceinline__ void fill_run(T* rc, T* ra, const T* src_c,
                                         const T* src_a, int D, bool async16,
                                         const T* cend, const T* aend,
                                         int lane) {
  if (async16) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = D / kPer;
    const int n = src_a == nullptr ? chunks : 2 * chunks;
    for (int c = lane; c < n; c += 32) {
      if (c < chunks)
        cp_async16(rc + c * kPer, src_c + c * kPer);
      else
        cp_async16(ra + (c - chunks) * kPer, src_a + (c - chunks) * kPer);
    }
  } else if constexpr (kWords) {
    copy_run(rc, src_c, D, cend, lane);
    if (src_a != nullptr) copy_run(ra, src_a, D, aend, lane);
  } else {
    for (int d = lane; d < D; d += 32) {
      rc[d] = src_c[d];
      if (src_a != nullptr) ra[d] = src_a[d];
    }
  }
}

// P2a = max(P1 * 3 / 2, P2 / (|dI| + 1)) for |dI| below 256, by the
// block's threads; a __syncthreads() must follow.
__device__ __forceinline__ void fill_p2a(int* tab, int p1, int p2) {
  const int p2min = p1 * 3 / 2;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    tab[i] = max(p2min, p2 / (i + 1));
}

// One chain of one path, walked by one warp (the line and path kernels):
// n scan positions, position t's depth runs at cc + t * step (the cost),
// ca + t * step (the accumulator; null: none) and co + t * step (the
// result), its intensity at ic[t * istep]. Writes co = ca + path, or the
// path itself where ca is null; ca may be co (in place): no other warp
// touches the chain's positions, and each is read into the ring before it
// is written. The path restarts from the raw cost at t = 0.
// - The ring: S stages of A rows (cost, accumulator) of R elements, the
//   warp's own, filled by fill_run S - 1 steps ahead (one copy group a
//   step, empty past the end), so every address of the chain can be in
//   flight; it is ordered by __syncwarp alone, so no step waits on a block
//   barrier.
// - The intensities come 32 steps at a time, one a lane, handed out by a
//   shuffle; min(prev) is one redux.sync; P2a comes from p2a_tab below 256
//   (a division above); each depth's step is min_plus's (DPX at K >= 8).
template <typename T, int K, int S, int A, int R, bool kWords,
          bool kStageOut = false>
__device__ __forceinline__ void walk_chain(
    T* ring, const int* p2a_tab, const T* cc, const T* ca, T* co, int n,
    long long step, const int32_t* ic, long long istep, int D, int p1,
    int p2, bool vec, bool async16, const T* cend, const T* aend,
    int lane) {
  if (A < 2) ca = nullptr;  // no row for it
  const int d0 = lane * K;
  const int p2min = p1 * 3 / 2;
  auto row = [&](int s, int a) { return ring + ((s % S) * A + a) * R; };
  auto fill = [&](int s) {
    if (s < n) {
      const long long go = s * step;
      fill_run<T, kWords>(row(s, 0), A > 1 ? row(s, A - 1) : nullptr,
                          cc + go, ca == nullptr ? nullptr : ca + go, D,
                          async16, cend, aend, lane);
    }
    cp_async_commit();
  };
  // Intensities of scan steps [32c, 32c + 32), lane j holding step 32c + j.
  auto inten_run = [&](int c) {
    const int s = c * 32 + lane;
    return s < n ? ic[s * istep] : 0;
  };
  auto p2a_of = [&](int i_cur, int i_prev) {
    const int d = abs(i_cur - i_prev);
    return d < 256 ? p2a_tab[d] : max(p2min, p2 / (d + 1));
  };

  for (int s = 0; s < S - 1; ++s) fill(s);
  int run = inten_run(0), next_run = inten_run(1);
  int prev[K];
  int prev_i = 0;
  for (int t = 0; t < n; ++t) {
    __syncwarp();  // every lane has read the stage of step t - 1
    fill(t + S - 1);  // into that stage
    cp_async_wait<S - 1>();  // this lane's copies for step t
    __syncwarp();  // and every other lane's
    if (t > 0 && (t & 31) == 0) {
      run = next_run;
      next_run = inten_run((t >> 5) + 1);
    }
    const int it = __shfl_sync(kFull, run, t & 31);
    const long long go = t * step;
    // Where the ring rows hold the run from (copy_run), and whether this
    // lane's depths there may be read whole.
    const int sc = ring_start<T, kWords>(cc + go, async16);
    const int sa =
        ca == nullptr ? 0 : ring_start<T, kWords>(ca + go, async16);
    int cur[K], av[K], nv[K];
    load_k<T, K>(row(t, 0) + sc + d0, cur, d0, D, sc == 0);
    if (ca != nullptr)
      load_k<T, K>(row(t, A - 1) + sa + d0, av, d0, D, sa == 0);
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) nv[k] = cur[k];
    } else {
      min_plus<K, true>(prev, cur, lane, p1, p2a_of(it, prev_i), nv);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k >= D) nv[k] = kBig;
      prev[k] = nv[k];
      av[k] = ca == nullptr ? nv[k] : av[k] + nv[k];
    }
    if (kStageOut && vec) {
      // Through the stage just read: a lane's own run is wider than 16
      // bytes, so its 16-byte pieces would land 32 or 64 bytes apart
      // across the lanes; here consecutive lanes write consecutive pieces.
      T* st = row(t, 0);
      __syncwarp();  // every lane has read the stage
      store_k<T, K>(st + d0, av, d0, D, true);
      __syncwarp();
      constexpr int kPer = 16 / sizeof(T);
      for (int c = lane; c < D / kPer; c += 32)
        reinterpret_cast<int4*>(co + go)[c] =
            reinterpret_cast<const int4*>(st)[c];
    } else {
      store_k<T, K>(co + go + d0, av, d0, D, vec);
    }
    prev_i = it;
  }
}

// One straight sweep of B int16 problems: out = acc + path, or out = path
// where acc is null; acc may be out (in place). One warp a line, walked by
// walk_chain from the sweep's first scan position. async16: every depth
// run is 16-byte aligned and D % 8 == 0, so the ring is filled by cp.async
// in 16-byte pieces; otherwise by plain loads at K <= 4 and by the 4-byte
// words that cover each run at K = 8 and 16.
template <int K>
__global__ void __launch_bounds__(kChainWarps * 32)
    sgm_line_kernel(const int16_t* __restrict__ cost,
                    const int32_t* __restrict__ inten, const int16_t* acc,
                    int16_t* out, int B, int X, int L, int D, long long vb,
                    long long vx, long long vl, long long ib, long long ix,
                    long long il, int reverse, int p1, int p2, bool vec,
                    bool async16) {
  constexpr int S = LineRing<K>::kStages;
  constexpr int R = LineRing<K>::kRow;
  // [warp][stage][cost, acc][d]
  __shared__ __align__(16) int16_t ring[kChainWarps][S][2][R];
  __shared__ int p2a_tab[256];  // P2a by |dI| below 256
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  fill_p2a(p2a_tab, p1, p2);
  __syncthreads();  // the only block barrier
  const long long line =
      static_cast<long long>(blockIdx.x) * kChainWarps + w;
  if (line >= static_cast<long long>(B) * L) return;  // whole warp
  const long long b = line / L;
  const long long l = line - b * L;
  const long long x0 = reverse ? X - 1 : 0;  // the sweep's first position
  const long long first = b * vb + x0 * vx + l * vl;
  walk_chain<int16_t, K, S, 2, R, (K >= 8)>(
      &ring[w][0][0][0], p2a_tab, cost + first,
      acc == nullptr ? nullptr : acc + first, out + first, X,
      reverse ? -vx : vx, inten + b * ib + x0 * ix + l * il,
      reverse ? -ix : ix, D, p1, p2, vec, async16, cost + B * vb,
      acc == nullptr ? nullptr : acc + B * vb, lane);
}

template <int K>
cudaError_t launch_line(const void* cost, const void* inten, const void* acc,
                        void* out, int B, int X, int L, int D, long long vb,
                        long long vx, long long vl, long long ib,
                        long long ix, long long il, int reverse, int p1,
                        int p2, cudaStream_t stream) {
  const bool vec = sweep_vec<K>(out, D, vb, vx, vl);
  const bool async16 =
      D % 8 == 0 && vb % 8 == 0 && vx % 8 == 0 && vl % 8 == 0 &&
      reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const long long lines = static_cast<long long>(B) * L;
  const long long blocks = (lines + kChainWarps - 1) / kChainWarps;
  sgm_line_kernel<K>
      <<<static_cast<unsigned>(blocks), kChainWarps * 32, 0, stream>>>(
          static_cast<const int16_t*>(cost),
          static_cast<const int32_t*>(inten),
          static_cast<const int16_t*>(acc), static_cast<int16_t*>(out), B, X,
          L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, vec, async16);
  return cudaGetLastError();
}

// sgm_path_kernel's ring by storage: rows of 32 K elements and the word an
// odd start adds, a multiple of 16 bytes; as many positions (2 to 32) as
// hold kPathRingBytes of what a step reads (the cost, and the accumulator
// where it adds) at every K and element size: at 4 KB, 8 at D = 128
// adding int16 or writing int32 (16 writing int16), 4 at K = 8, 2 at
// K = 16 (4 writing int16).
template <typename T, int K, bool kAdd>
struct PathRing {
  static constexpr int kArrays = kAdd ? 2 : 1;
  static constexpr int kRow = 32 * K + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStepBytes =
      32 * K * static_cast<int>(sizeof(T)) * kArrays;
  static constexpr int kStages =
      kPathRingBytes / kStepBytes < 2
          ? 2
          : (kPathRingBytes / kStepBytes > 32 ? 32
                                              : kPathRingBytes / kStepBytes);
};

// One path of B problems in one direction. kAdd: out += path in place
// (int16); otherwise out = path (int32 for row 5, int16 for the first
// launch of an 8-path sum on the per-path route, cuda_agg.per_path_plan).
// Warp (b, c) walks chain c of problem b with walk_chain: c < L from scan
// step 0 on line c; c >= L (a diagonal's) from step c - L + 1 on the
// border line (0 for shift +1, L - 1 for -1). A chain ends where the scan
// does or where its line leaves [0, L): the corners' chains are one
// position long. async16: every position's runs are 16-byte aligned (the
// strides, so the diagonal's step vx + shift * vl, too) and D a multiple
// of 16 bytes: the ring takes 16-byte pieces; otherwise the 4-byte words
// that cover each run.
template <typename T, int K, bool kAdd>
__global__ void __launch_bounds__(kPathWarps * 32)
    sgm_path_kernel(const T* __restrict__ cost,
                    const int32_t* __restrict__ inten, T* out, int B, int X,
                    int L, int D, long long vb, long long vx, long long vl,
                    long long ib, long long ix, long long il, int reverse,
                    int shift, int p1, int p2, bool vec, bool async16) {
  using Ring = PathRing<T, K, kAdd>;
  // [warp][stage][cost, acc][d]
  __shared__ __align__(16)
      T ring[kPathWarps][Ring::kStages][Ring::kArrays][Ring::kRow];
  __shared__ int p2a_tab[256];  // P2a by |dI| below 256
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  fill_p2a(p2a_tab, p1, p2);
  __syncthreads();  // the only block barrier
  const long long n_chains = shift ? static_cast<long long>(L) + X - 1
                                   : static_cast<long long>(L);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kPathWarps + w;
  if (warp >= B * n_chains) return;  // whole warp
  const long long b = warp / n_chains;
  const long long c = warp - b * n_chains;
  int t0 = 0;
  int l0;
  if (c < L) {
    l0 = static_cast<int>(c);
  } else {
    t0 = static_cast<int>(c - L + 1);
    l0 = shift > 0 ? 0 : L - 1;
  }
  int n = X - t0;
  if (shift > 0) n = min(n, L - l0);
  if (shift < 0) n = min(n, l0 + 1);
  const long long x0 = reverse ? X - 1 - t0 : t0;
  const long long first = b * vb + x0 * vx + l0 * vl;
  walk_chain<T, K, Ring::kStages, Ring::kArrays, Ring::kRow, true,
             (kPathStageOut && sizeof(T) * K > 16)>(
      &ring[w][0][0][0], p2a_tab, cost + first,
      kAdd ? out + first : nullptr, out + first, n,
      (reverse ? -vx : vx) + shift * vl, inten + b * ib + x0 * ix + l0 * il,
      (reverse ? -ix : ix) + shift * il, D, p1, p2, vec, async16,
      cost + B * vb, out + B * vb, lane);
}

template <typename T, int K, bool kAdd>
cudaError_t launch_path(const void* cost, const void* inten, void* out,
                        int B, int X, int L, int D, long long vb,
                        long long vx, long long vl, long long ib,
                        long long ix, long long il, int reverse, int shift,
                        int p1, int p2, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  const bool vec = sweep_vec<K, T>(out, D, vb, vx, vl);
  const bool async16 =
      D % kPer == 0 && vb % kPer == 0 && vx % kPer == 0 && vl % kPer == 0 &&
      reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n_chains =
      shift ? static_cast<long long>(L) + X - 1 : static_cast<long long>(L);
  const long long blocks =
      (static_cast<long long>(B) * n_chains + kPathWarps - 1) / kPathWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sgm_path_kernel<T, K, kAdd>
      <<<static_cast<unsigned>(blocks), kPathWarps * 32, 0, stream>>>(
          static_cast<const T*>(cost), static_cast<const int32_t*>(inten),
          static_cast<T*>(out), B, X, L, D, vb, vx, vl, ib, ix, il, reverse,
          shift, p1, p2, vec, async16);
  return cudaGetLastError();
}

template <typename T, bool kAdd>
cudaError_t launch_path_k(const void* cost, const void* inten, void* out,
                          int B, int X, int L, int D, long long vb,
                          long long vx, long long vl, long long ib,
                          long long ix, long long il, int reverse, int shift,
                          int p1, int p2, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch_path<T, 1, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 2: return launch_path<T, 2, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 3: return launch_path<T, 3, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 4: return launch_path<T, 4, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 5: case 6: case 7: case 8:
      return launch_path<T, 8, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    default:
      return launch_path<T, 16, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
  }
}

// sgm_deep_sweep_kernel's shared memory (byte offsets) for `lines` lines of
// G = 32 * W threads and Dp = G * K depths each, S ring stages, with or
// without the diagonals' buffers. The wrapper's plan mirrors this layout
// (cuda_agg.deep_sweep_smem_bytes).
struct DeepSweepLayout {
  int diag;   // int32 [2 (+1, -1)][lines][2 parity][K][G]
  int ring;   // int16 [S][lines][Dp + 8]: the cost
  int inten;  // int32 [S][lines + 2]: lines l0 - 1 .. l0 + lines
  int p2a;    // int32 [256]
  int pmin;   // int32 [2 parity][3 paths][lines][W]: warps' minima
  int lohi;   // int32 [2 parity][lines][W][2]: straight line's warp ends
  int bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline DeepSweepLayout deep_sweep_layout(
    int lines, int W, int K, int S, bool diag) {
  const int G = 32 * W, Dp = G * K;
  DeepSweepLayout s;
  int o = 0;
  s.diag = o;
  o += diag ? align16(2 * 2 * lines * Dp * 4) : 0;
  s.ring = o;
  o += align16(S * lines * (Dp + 8) * 2);
  s.inten = o;
  o += align16(S * (lines + 2) * 4);
  s.p2a = o;
  o += 256 * 4;
  s.pmin = o;
  o += align16(2 * 3 * lines * W * 4);
  s.lohi = o;
  o += align16(2 * lines * W * 2 * 4);
  s.bytes = o;
  return s;
}

// K depths of one position as K / 2 words of two int16 (K even), in pieces
// of 16, 8 or 4 bytes as K allows (the widest whose lanes' runs stay
// aligned), so that consecutive lanes read without bank conflicts.
template <int K>
struct Pairs {
  static constexpr int kWords = K % 8 == 0 ? 4 : K % 4 == 0 ? 2 : 1;
  static constexpr int kBytes = 4 * kWords;
};

// kW words (2 kW int16) at p, aligned to 4 kW bytes.
template <int kW>
__device__ __forceinline__ void load_piece(const int16_t* p,
                                           uint32_t (&v)[kW]) {
  if constexpr (kW == 4) {
    const uint4 s = *reinterpret_cast<const uint4*>(p);
    v[0] = s.x;
    v[1] = s.y;
    v[2] = s.z;
    v[3] = s.w;
  } else if constexpr (kW == 2) {
    const uint2 s = *reinterpret_cast<const uint2*>(p);
    v[0] = s.x;
    v[1] = s.y;
  } else {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int K>
__device__ __forceinline__ void load_pairs(const int16_t* p,
                                           uint32_t (&v)[K / 2]) {
  constexpr int kW = Pairs<K>::kWords;
#pragma unroll
  for (int c = 0; c < K / 2 / kW; ++c) {
    uint32_t s[kW];
    load_piece<kW>(p + 2 * kW * c, s);
#pragma unroll
    for (int j = 0; j < kW; ++j) v[kW * c + j] = s[j];
  }
}

template <int K>
__device__ __forceinline__ void store_pairs(int16_t* p,
                                            const uint32_t (&v)[K / 2]) {
  constexpr int kW = Pairs<K>::kWords;
#pragma unroll
  for (int c = 0; c < K / 2 / kW; ++c) {
    if constexpr (kW == 4) {
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else if constexpr (kW == 2) {
      reinterpret_cast<uint2*>(p)[c] = make_uint2(v[2 * c], v[2 * c + 1]);
    } else {
      reinterpret_cast<uint32_t*>(p)[c] = v[c];
    }
  }
}

// Depths [d0, d0 + K) of a position in device memory; depths >= D read as
// 0. vec: the pieces are aligned (Pairs<K>::kBytes).
template <int K>
__device__ __forceinline__ void load_pairs_global(const int16_t* p,
                                                  uint32_t (&v)[K / 2],
                                                  int d0, int D, bool vec) {
  if (vec && d0 + K <= D) {
    load_pairs<K>(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    const int lo = d0 + 2 * j < D ? p[2 * j] : 0;
    const int hi = d0 + 2 * j + 1 < D ? p[2 * j + 1] : 0;
    v[j] = (static_cast<uint32_t>(lo) & 0xffffu) |
           (static_cast<uint32_t>(hi) << 16);
  }
}

template <int K>
__device__ __forceinline__ void store_pairs_global(int16_t* p,
                                                   const uint32_t (&v)[K / 2],
                                                   int d0, int D, bool vec) {
  if (vec && d0 + K <= D) {
    store_pairs<K>(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    if (d0 + 2 * j < D) p[2 * j] = static_cast<int16_t>(v[j] & 0xffffu);
    if (d0 + 2 * j + 1 < D) p[2 * j + 1] = static_cast<int16_t>(v[j] >> 16);
  }
}

// Element k of K / 2 pair words, sign-extended; and the word with element k
// replaced by the low 16 bits of x.
template <int K>
__device__ __forceinline__ int pair_at(const uint32_t (&v)[K / 2], int k) {
  const uint32_t w = v[k >> 1];
  return (k & 1) ? static_cast<int>(w) >> 16
                 : static_cast<int>(static_cast<int16_t>(w & 0xffffu));
}

template <int K>
__device__ __forceinline__ void pair_set(uint32_t (&v)[K / 2], int k, int x) {
  const uint32_t u = static_cast<uint32_t>(x) & 0xffffu;
  v[k >> 1] = (k & 1) ? (v[k >> 1] & 0xffffu) | (u << 16)
                      : (v[k >> 1] & 0xffff0000u) | u;
}

constexpr int kPollLimit = 1 << 24;

// A tagged word read or written at device scope (around L1), without the
// compiler barrier of load_relaxed / store_relaxed: the deep sweep kernel
// needs no order between these and its other accesses beyond their data
// dependences, and a barrier inside its per-depth loop would hold every
// shared-memory access of the loop in place.
__device__ __forceinline__ unsigned long long ld_tagged(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_tagged(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v));
}

// An edge line as a neighbouring block publishes it: [K][G] words, word
// k G + g holding depth g K + k, then the W warps' minima, every word
// tagged with the scan step that wrote it. fetch_edge copies the words this
// thread reads (its K depths and the depths just past its ends) into `raw`
// (the same layout) with cp.async 16-byte pieces of two threads' words,
// which read L2 and spend no registers, as one copy group (two threads
// copy a piece each; the bytes are the same); tagged_value then takes a
// word's value once it carries `step`, reading it again at device scope
// until it does. The blocks are resident together, so a wait lasts
// microseconds; after kPollLimit reads (seconds) the kernel traps, and
// the launch fails rather than hangs.
template <int K>
__device__ __forceinline__ void fetch_edge(unsigned long long* raw,
                                           const unsigned long long* src,
                                           int g, int G) {
  const int g2 = g & ~1;
#pragma unroll
  for (int k = 0; k < K; ++k) cp_async16(raw + k * G + g2, src + k * G + g2);
  if (g > 0) {
    const int i = (K - 1) * G + ((g - 1) & ~1);
    cp_async16(raw + i, src + i);
  }
  if (g + 1 < G) {
    const int i = (g + 1) & ~1;
    cp_async16(raw + i, src + i);
  }
}

__device__ __forceinline__ int tagged_value(unsigned long long e,
                                            const unsigned long long* p,
                                            unsigned step) {
  for (int round = 0; static_cast<unsigned>(e >> 32) != step; ++round) {
    if (round == kPollLimit) __trap();
    e = ld_tagged(p);
  }
  return static_cast<int>(static_cast<unsigned>(e));
}

__device__ __forceinline__ unsigned long long tagged(unsigned step, int v) {
  return static_cast<unsigned long long>(step) << 32 | static_cast<unsigned>(v);
}

// Cost K at this thread's depths from its ring row: the depth k one. With
// kAligned the run starts on a piece, read a piece (kPiece depths, two to
// a 32-bit word) at a time; otherwise it may start on an odd element and is
// read a depth at a time.
template <int K, bool kAligned>
struct CostPieces {
  static constexpr int kW = Pairs<K>::kWords, kPiece = 2 * kW;
  uint32_t w[kW];
  __device__ __forceinline__ int at(const int16_t* ring, int k) {
    if constexpr (!kAligned) return ring[k];
    if (k % kPiece == 0) load_piece<kW>(ring + k, w);
    const uint32_t c = w[(k % kPiece) >> 1];
    return (k & 1) ? static_cast<int>(c) >> 16
                   : static_cast<int>(static_cast<int16_t>(c & 0xffffu));
  }
};

// One diagonal's new line at this thread's depths d0 .. d0 + K - 1 from
// its line of step t - 1 (restart: the cost itself): another row's, [K][G]
// ints at `src` (kEdgeIn false), or the incoming edge line, [K][G] tagged
// words at `raw` with `graw` the same words in device memory for a word
// that does not carry step t - 1 yet (kEdgeIn). dn and up_last are prev
// just past this thread's depths, mp = m + P2a. The line goes to `dst`
// ([K][G], when not null), to `pub` tagged with t (kPub), and into the
// pair sums `av` (kSum). Returns the minimum over these depths.
template <int K, bool kAligned, bool kEdgeIn, bool kPub, bool kSum>
__device__ __forceinline__ int diag_line(
    const int16_t* ring, const int* src, const unsigned long long* raw,
    const unsigned long long* graw, int* dst, unsigned long long* pub,
    uint32_t (&av)[K / 2], bool restart, int dn, int up_last, int mp, int m,
    int p1, int d0, int D, int g, int G, unsigned t) {
  auto prev = [&](int k) {
    if constexpr (kEdgeIn)
      return tagged_value(raw[k * G + g], graw + k * G + g, t - 1);
    else
      return src[k * G + g];
  };
  CostPieces<K, kAligned> cost;
  int a = restart ? 0 : prev(0);
  int mn = kBig;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int nv = cost.at(ring, k);
    if (!restart) {
      const int up = k + 1 < K ? prev(k + 1) : up_last;
      nv = sgm_step(nv, a, dn, up, p1, mp, m);
      dn = a;
      a = up;
    }
    if (d0 + k >= D) nv = kBig;
    if (dst != nullptr) dst[k * G + g] = nv;
    if constexpr (kPub) st_tagged(pub + k * G + g, tagged(t, nv));
    if constexpr (kSum) pair_set<K>(av, k, pair_at<K>(av, k) + nv);
    mn = min(mn, nv);
  }
  return mn;
}

// diag_line with the source kind and the publishing chosen at run time.
template <int K, bool kAligned, bool kSum>
__device__ __forceinline__ int diag_line_any(
    bool edge_in, bool publish, const int16_t* ring, const int* src,
    const unsigned long long* raw, const unsigned long long* graw, int* dst,
    unsigned long long* pub, uint32_t (&av)[K / 2], bool restart, int dn,
    int up_last, int mp, int m, int p1, int d0, int D, int g, int G,
    unsigned t) {
  if (edge_in && publish)
    return diag_line<K, kAligned, true, true, kSum>(ring, src, raw, graw, dst, pub, av,
                                          restart, dn, up_last, mp, m, p1, d0,
                                          D, g, G, t);
  if (edge_in)
    return diag_line<K, kAligned, true, false, kSum>(ring, src, raw, graw, dst, pub, av,
                                           restart, dn, up_last, mp, m, p1,
                                           d0, D, g, G, t);
  if (publish)
    return diag_line<K, kAligned, false, true, kSum>(ring, src, raw, graw, dst, pub,
                                           av, restart, dn, up_last, mp, m,
                                           p1, d0, D, g, G, t);
  return diag_line<K, kAligned, false, false, kSum>(ring, src, raw, graw, dst, pub, av,
                                          restart, dn, up_last, mp, m, p1, d0,
                                          D, g, G, t);
}

// A warp's minimum of an edge line, tagged with step t, into word `word`
// of the published line (lane 0); the warp's minimum of `mn` first.
__device__ __forceinline__ void publish_min(unsigned long long* pub, int mn,
                                            unsigned t, int word, int lane) {
  const int m = __reduce_min_sync(kFull, mn);
  if (lane == 0) st_tagged(pub + word, tagged(t, m));
}

constexpr int kDeepSweepThreads = 1024;     // straight-only launches
constexpr int kDeepSweepDiagThreads = 640;  // launches with a diagonal
// Ring stages: with a diagonal 2 (a step ahead; 3 measured no faster,
// PERF.md), straight only 4.
constexpr int kDeepSweepStages = 2;
constexpr int kDeepSweepLineStages = 4;

// One sweep of the distinct shifts in `paths` (bit 0: straight, bit 1: +1,
// bit 2: -1) over B int16 problems at up to kDeepMaxD depths: out = acc +
// paths (acc == out adds in place; a null acc writes the paths alone).
// Block (b, tile) owns `lines` consecutive lines of problem b, each walked
// by G = 32 * W threads of K depths (the sweep's design is at the head of
// this file). kDiag: the launch carries a diagonal and is cooperative;
// edge: [B, tiles, 4 (step % 4), (+1, -1), K * G + 32] tagged words, all
// -1 before the launch. The cost ring is filled by cp.async: kAligned,
// every depth run is 16-byte aligned and D % 8 == 0, in 16-byte pieces;
// otherwise in the 4-byte words that cover the run, which start one
// element early (a row's shift) where the run starts on an odd element.
// vec: acc and out may be read and written in Pairs<K>::kBytes pieces.
template <int K, bool kDiag, bool kAligned>
__global__ void __launch_bounds__(kDiag ? kDeepSweepDiagThreads
                                        : kDeepSweepThreads, 1)
    sgm_deep_sweep_kernel(const int16_t* __restrict__ cost,
                          const int32_t* __restrict__ inten,
                          const int16_t* acc, int16_t* out,
                          unsigned long long* __restrict__ edge, int X, int L,
                          int D, long long vb, long long vx, long long vl,
                          long long ib, long long ix, long long il,
                          int reverse, int paths, int p1, int p2, int lines,
                          int W, bool vec) {
  constexpr int S = kDiag ? kDeepSweepStages : kDeepSweepLineStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DeepSweepLayout lay = deep_sweep_layout(lines, W, K, S, kDiag);
  int* s_diag = reinterpret_cast<int*>(smem_raw + lay.diag);
  int16_t* s_ring = reinterpret_cast<int16_t*>(smem_raw + lay.ring);
  int* s_inten = reinterpret_cast<int*>(smem_raw + lay.inten);
  int* s_p2a = reinterpret_cast<int*>(smem_raw + lay.p2a);
  int* s_pmin = reinterpret_cast<int*>(smem_raw + lay.pmin);
  int* s_lohi = reinterpret_cast<int*>(smem_raw + lay.lohi);
  const int G = 32 * W;
  const int Dp = G * K;
  const int Rp = Dp + 8;  // a ring row: a run and the word past it
  const int r = threadIdx.x / G;  // the block's line this thread walks
  const int g = threadIdx.x - r * G;
  const int w = g >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (L + lines - 1) / lines;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int l = tile * lines + r;
  const bool active = l < L;
  const int last = min(lines, L - tile * lines) - 1;  // the last line's row
  const bool straight = paths & 1, plus = paths & 2, minus = paths & 4;
  // The edge rows trade with the neighbouring blocks whenever a diagonal
  // runs, in both directions even if one diagonal is absent (its minima
  // words only), as sgm_sweep3_kernel's edge warps do.
  const bool trade_l = kDiag && (plus || minus) && r == 0 && tile > 0;
  const bool trade_r =
      kDiag && (plus || minus) && r == last && tile + 1 < tiles;
  // An edge row's outgoing diagonal (+1 of the last row, -1 of the first)
  // is computed ahead of the row's other work and published first where
  // its source is another row of the block; a block of one line computes
  // it in its main pass, after reading its neighbours.
  const bool early_p = trade_r && r > 0;
  const bool early_m = trade_l && r + 1 < lines;
  const int d0 = g * K;
  const int p2min = p1 * 3 / 2;
  const int16_t* cb = cost + b * vb;
  const int16_t* ab = acc == nullptr ? nullptr : acc + b * vb;
  int16_t* ob = out + b * vb;
  const int32_t* ibase = inten + b * ib;
  const int ew = K * G + 32;  // words of one edge line
  // Edge line of block `tl` written at step s (slot s % 4), direction 0:
  // +1 of its last line, 1: -1 of its first line.
  auto edge_line = [&](int tl, int s, int dir) {
    return edge + ((static_cast<long long>(b) * tiles + tl) * 8 +
                   (s & 3) * 2 + dir) * ew;
  };
  auto pos = [&](int s) {
    return static_cast<long long>(reverse ? X - 1 - s : s);
  };
  // [dir][row][par][K][G], [par][path][row][W], [par][row][W][2]
  auto diag_row = [&](int par, int dir, int row) {
    return s_diag + ((dir * lines + row) * 2 + par) * Dp;
  };
  auto pmin_at = [&](int par, int path, int row) {
    return s_pmin + ((par * 3 + path) * lines + row) * W;
  };
  auto lohi_at = [&](int par, int row) {
    return s_lohi + ((par * lines + row) * W) * 2;
  };
  // Nobody in the block reads the first row's -1 line or the last row's
  // +1 line (they go to the neighbouring blocks), so both parities of each
  // hold the edge line that comes in there: K G tagged words, [K][G].
  unsigned long long* raw_p =
      reinterpret_cast<unsigned long long*>(s_diag + (lines * 2) * Dp);
  unsigned long long* raw_m = reinterpret_cast<unsigned long long*>(
      s_diag + ((lines - 1) * 2) * Dp);

  // A run's first element in its ring row: 1 where the words that cover
  // it start one element early.
  auto shift = [&](int s) {
    if constexpr (kAligned) return 0;
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(cb + pos(s) * vx + l * vl) >> 1) & 1);
  };
  const int16_t* cend = cost + static_cast<long long>(gridDim.x / tiles) * vb;
  // Ring stage of scan step s: the cost and the intensities, S - 1 steps
  // ahead of its use; one copy group per step.
  auto fill = [&](int s) {
    if (s < X) {
      const int q = s % S;
      int16_t* dst = s_ring + (q * lines + r) * Rp;
      const int16_t* src = cb + pos(s) * vx + l * vl;
      if (active && kAligned) {
        for (int c = g; c < D / 8; c += G)
          cp_async16(dst + c * 8, src + c * 8);
      } else if (active) {
        src -= shift(s);
        for (int c = g; 2 * c < D + shift(s); c += G) {
          if (src + 2 * c + 2 <= cend)
            cp_async4(dst + 2 * c, src + 2 * c);
          else  // the volume's last element: its word would leave it
            dst[2 * c] = src[2 * c];
        }
      }
      const int li = tile * lines - 1 + static_cast<int>(threadIdx.x);
      if (static_cast<int>(threadIdx.x) < lines + 2 && li >= 0 && li < L)
        cp_async4(&s_inten[q * (lines + 2) + threadIdx.x],
                  ibase + pos(s) * ix + li * il);
    }
    cp_async_commit();
  };

  for (int s = 0; s < S - 1; ++s) fill(s);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_p2a[i] = max(p2min, p2 / (i + 1));
  cp_async_wait<S - 2>();
  __syncthreads();
  auto p2a_of = [&](int i_cur, int i_prev) {
    const int d = abs(i_cur - i_prev);
    return d < 256 ? s_p2a[d] : max(p2min, p2 / (d + 1));
  };

  int prev_s[K];  // the straight path's line, at this thread's depths
#pragma unroll
  for (int k = 0; k < K; ++k) prev_s[k] = kBig;
  // I at the previous position of lines l, l - 1 and l + 1.
  int prev_i = 0, prev_il = 0, prev_ir = 0;
  for (int t = 0; t < X; ++t) {
    // The edge lines that come in at step t - 1: this thread's run by
    // cp.async (its own copy group, issued first), the words just past it
    // and the warps' minima read directly; all checked just before use.
    const bool in_p = trade_l && t > 0;  // into row 0, +1 from the left
    const bool in_m = trade_r && t > 0;  // into the last row, -1 from the right
    const unsigned long long* gp = in_p ? edge_line(tile - 1, t - 1, 0)
                                        : nullptr;
    const unsigned long long* gm = in_m ? edge_line(tile + 1, t - 1, 1)
                                        : nullptr;
    unsigned long long e_mp = 0, e_mm = 0;
    if constexpr (kDiag) {
      if (in_p && plus) fetch_edge<K>(raw_p, gp, g, G);
      if (in_m && minus) fetch_edge<K>(raw_m, gm, g, G);
      if (in_p && lane < W) e_mp = ld_tagged(gp + K * G + lane);
      if (in_m && lane < W) e_mm = ld_tagged(gm + K * G + lane);
      cp_async_commit();
    }
    fill(t + S - 1);  // into the stage read at step t - 1
    const int q = t % S;
    const int par = t & 1;
    const int pp = par ^ 1;
    if (active) {
      const int it = s_inten[q * (lines + 2) + r + 1];
      uint32_t av[K / 2];  // acc + paths, two int16 to a word
      if (ab != nullptr) {
        load_pairs_global<K>(ab + pos(t) * vx + l * vl + d0, av, d0, D, vec);
      } else {
#pragma unroll
        for (int j = 0; j < K / 2; ++j) av[j] = 0;
      }
      // Each path's min(prev), min(prev) + P2a, and prev just past this
      // thread's depths, from step t - 1.
      int m_s = 0, mp_s = 0, dn_s = kBig, up_s = kBig;
      if (straight && t > 0) {
        m_s = __reduce_min_sync(kFull,
                                lane < W ? pmin_at(pp, 0, r)[lane] : kBig);
        mp_s = m_s + p2a_of(it, prev_i);
        dn_s = __shfl_up_sync(kFull, prev_s[K - 1], 1);
        up_s = __shfl_down_sync(kFull, prev_s[0], 1);
        if (lane == 0) dn_s = w > 0 ? lohi_at(pp, r)[(w - 1) * 2 + 1] : kBig;
        if (lane == 31) up_s = w + 1 < W ? lohi_at(pp, r)[(w + 1) * 2] : kBig;
      }
      // A path restarts from the cost at the scan's start and where it
      // enters through the border line; otherwise line l continues line
      // l - 1 (+1) or l + 1 (-1) of step t - 1: another row of this block,
      // or (the first and the last row) the neighbouring block's edge line.
      const bool restart_p = !plus || t == 0 || l == 0;
      const bool restart_m = !minus || t == 0 || l == L - 1;
      const int* src_p = diag_row(pp, 0, r - 1);
      const int* src_m = diag_row(pp, 1, r + 1);
      int m_p = 0, dn_p = kBig, up_p = kBig;
      int m_m = 0, dn_m = kBig, up_m = kBig;
      if constexpr (kDiag) {
        if (!restart_p && !in_p) {
          m_p = __reduce_min_sync(
              kFull, lane < W ? pmin_at(pp, 1, r - 1)[lane] : kBig);
          dn_p = g > 0 ? src_p[(K - 1) * G + g - 1] : kBig;
          up_p = g + 1 < G ? src_p[g + 1] : kBig;
        }
        if (!restart_m && !in_m) {
          m_m = __reduce_min_sync(
              kFull, lane < W ? pmin_at(pp, 2, r + 1)[lane] : kBig);
          dn_m = g > 0 ? src_m[(K - 1) * G + g - 1] : kBig;
          up_m = g + 1 < G ? src_m[g + 1] : kBig;
        }
        const int16_t* ring = s_ring + (q * lines + r) * Rp + shift(t) + d0;
        if (early_p) {  // an absent path publishes its minima words only
          int mn = kBig;
          if (plus)
            mn = diag_line<K, kAligned, false, true, false>(
                ring, src_p, nullptr, nullptr, nullptr, edge_line(tile, t, 0),
                av, restart_p, dn_p, up_p, m_p + p2a_of(it, prev_il), m_p, p1,
                d0, D, g, G, t);
          publish_min(edge_line(tile, t, 0), mn, t, K * G + w, lane);
        }
        if (early_m) {
          int mn = kBig;
          if (minus)
            mn = diag_line<K, kAligned, false, true, false>(
                ring, src_m, nullptr, nullptr, nullptr, edge_line(tile, t, 1),
                av, restart_m, dn_m, up_m, m_m + p2a_of(it, prev_ir), m_m, p1,
                d0, D, g, G, t);
          publish_min(edge_line(tile, t, 1), mn, t, K * G + w, lane);
        }
        // The incoming edge lines: this thread's copies have landed.
        if (in_p || in_m) cp_async_wait<1>();
        if (in_p) {
          if (plus) {
            const int i = (K - 1) * G + g - 1;
            if (g > 0) dn_p = tagged_value(raw_p[i], gp + i, t - 1);
            if (g + 1 < G) up_p = tagged_value(raw_p[g + 1], gp + g + 1, t - 1);
          }
          m_p = __reduce_min_sync(
              kFull, lane < W ? tagged_value(e_mp, gp + K * G + lane, t - 1)
                              : kBig);
        }
        if (in_m) {
          if (minus) {
            const int i = (K - 1) * G + g - 1;
            if (g > 0) dn_m = tagged_value(raw_m[i], gm + i, t - 1);
            if (g + 1 < G) up_m = tagged_value(raw_m[g + 1], gm + g + 1, t - 1);
          }
          m_m = __reduce_min_sync(
              kFull, lane < W ? tagged_value(e_mm, gm + K * G + lane, t - 1)
                              : kBig);
        }
      }
      const int16_t* ring = s_ring + (q * lines + r) * Rp + shift(t) + d0;
      // The straight path, in registers.
      int mn_s = kBig, mn_p = kBig, mn_m = kBig;
      if (straight) {
        CostPieces<K, kAligned> cost;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = cost.at(ring, k);
          const int a = prev_s[k];
          const int up = k + 1 < K ? prev_s[k + 1] : up_s;
          int nv = t == 0 ? c : sgm_step(c, a, dn_s, up, p1, mp_s, m_s);
          if (d0 + k >= D) nv = kBig;
          dn_s = a;
          prev_s[k] = nv;
          mn_s = min(mn_s, nv);
          pair_set<K>(av, k, pair_at<K>(av, k) + nv);
        }
      }
      // The diagonals. Rows of the block read a row's +1 line from the next
      // row and its -1 line from the one before; the edge rows' outgoing
      // lines go out through the edge words only (the early ones are
      // published above, and computed again here for the sum).
      if constexpr (kDiag) {
        if (plus)
          mn_p = diag_line_any<K, kAligned, true>(
              in_p, trade_r && !early_p, ring, src_p, raw_p, gp,
              r + 1 < lines ? diag_row(par, 0, r) : nullptr,
              edge_line(tile, t, 0), av, restart_p, dn_p, up_p,
              m_p + p2a_of(it, prev_il), m_p, p1, d0, D, g, G, t);
        if (minus)
          mn_m = diag_line_any<K, kAligned, true>(
              in_m, trade_l && !early_m, ring, src_m, raw_m, gm,
              r > 0 ? diag_row(par, 1, r) : nullptr, edge_line(tile, t, 1),
              av, restart_m, dn_m, up_m, m_m + p2a_of(it, prev_ir), m_m, p1,
              d0, D, g, G, t);
      }
      store_pairs_global<K>(ob + pos(t) * vx + l * vl + d0, av, d0, D, vec);
      // Each path's minimum (and the straight line's warp ends) for step
      // t + 1; the edge lines' minima go out with their values.
      if (straight) {
        const int m = __reduce_min_sync(kFull, mn_s);
        if (lane == 0) {
          pmin_at(par, 0, r)[w] = m;
          lohi_at(par, r)[w * 2] = prev_s[0];
        }
        if (lane == 31) lohi_at(par, r)[w * 2 + 1] = prev_s[K - 1];
      }
      if constexpr (kDiag) {
        const int m_pn = __reduce_min_sync(kFull, mn_p);
        const int m_mn = __reduce_min_sync(kFull, mn_m);
        if (lane == 0) {
          if (plus) pmin_at(par, 1, r)[w] = m_pn;
          if (minus) pmin_at(par, 2, r)[w] = m_mn;
        }
        if (trade_r && !early_p)
          publish_min(edge_line(tile, t, 0), m_pn, t, K * G + w, lane);
        if (trade_l && !early_m)
          publish_min(edge_line(tile, t, 1), m_mn, t, K * G + w, lane);
      }
      prev_i = it;
      prev_il = s_inten[q * (lines + 2) + r];
      prev_ir = s_inten[q * (lines + 2) + r + 2];
    }
    cp_async_wait<S - 2>();  // this thread's copies for step t + 1
    __syncthreads();
  }
}

// The kernel for K depths a lane; the launch is cooperative with a
// diagonal (kDiag).
template <int K, bool kDiag>
cudaError_t launch_deep_sweep(const void* cost, const void* inten,
                              const void* acc, void* out, void* edge, int B,
                              int X, int L, int D, long long vb, long long vx,
                              long long vl, long long ib, long long ix,
                              long long il, int reverse, int paths, int p1,
                              int p2, int lines, int W, cudaStream_t stream) {
  constexpr bool diag = kDiag;
  const int vw = Pairs<K>::kBytes;
  bool vec = (2 * D) % vw == 0 && (2 * vb) % vw == 0 && (2 * vx) % vw == 0 &&
             (2 * vl) % vw == 0 &&
             reinterpret_cast<uintptr_t>(out) % vw == 0 &&
             reinterpret_cast<uintptr_t>(acc) % vw == 0;
  const bool aligned =
      D % 8 == 0 && vb % 8 == 0 && vx % 8 == 0 && vl % 8 == 0 &&
      reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  const int S = diag ? kDeepSweepStages : kDeepSweepLineStages;
  const int smem = deep_sweep_layout(lines, W, K, S, diag).bytes;
  const int tiles = (L + lines - 1) / lines;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(lines * 32 * W));
  const int16_t* c = static_cast<const int16_t*>(cost);
  const int32_t* i = static_cast<const int32_t*>(inten);
  const int16_t* a = static_cast<const int16_t*>(acc);
  int16_t* o = static_cast<int16_t*>(out);
  unsigned long long* ed = static_cast<unsigned long long*>(edge);
  void* args[] = {&c,  &i,  &a,  &o,       &ed,    &X,  &L,  &D,
                  &vb, &vx, &vl, &ib,      &ix,    &il, &reverse,
                  &paths, &p1, &p2, &lines, &W, &vec};
  const void* fn = aligned
                       ? (const void*)sgm_deep_sweep_kernel<K, kDiag, true>
                       : (const void*)sgm_deep_sweep_kernel<K, kDiag, false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (diag)
    return cudaLaunchCooperativeKernel(fn, grid, block, args, smem, stream);
  e = cudaLaunchKernel(fn, grid, block, args, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Warps per line and depths per lane of sgm_deep_sweep_kernel at D depths,
// so that the depths spread evenly over the warps and no warp holds a
// single one. Straight only: W = ceil(D / 512) warps, K = ceil(D / (32 W))
// rounded up to even (10 to 16 for 512 < D <= kDeepMaxD). With a diagonal
// a block holds one SM's lines and each step waits on its slowest warp, so
// a line takes about 4 warps: K = ceil(D / 128) rounded up to even, at
// most 16 (6 to 16), and W = ceil(D / (32 K)).
inline void deep_sweep_shape(int D, bool diag, int* W, int* K) {
  if (diag) {
    int k = (D + 127) / 128;
    k += k & 1;
    if (k > 16) k = 16;
    *K = k;
    *W = (D + 32 * k - 1) / (32 * k);
    return;
  }
  *W = (D + kPathMaxD - 1) / kPathMaxD;
  const int k = (D + 32 * *W - 1) / (32 * *W);
  *K = k + (k & 1);
}

constexpr int even_up(int k) { return k + (k & 1); }

// sgm_deep_kernel's depths a lane at D > kPathMaxD: K = ceil(D / (32
// kDeepWarps)) rounded up to even, so that about kDeepWarps warps walk a
// chain (K = 6, 8, 16 at D = 513, 1024, 2048), at least what keeps W <= 32
// warps, at most 16. kDeepMinK is the least K beyond kPathMaxD; a smaller
// D (the C function takes any) keeps it.
constexpr int kDeepMinK =
    even_up((kPathMaxD + 32 * kDeepWarps) / (32 * kDeepWarps));

// (W, K) of sgm_deep_kernel at D depths (cuda_agg.deep_shape mirrors it).
// For K < 16 it gives W <= kDeepWarps, and W <= 32 at K = 16.
inline void deep_shape(int D, int* W, int* K) {
  int k = even_up((D + 32 * kDeepWarps - 1) / (32 * kDeepWarps));
  const int k32 = even_up((D + 32 * kDeepMaxWarps - 1) / (32 * kDeepMaxWarps));
  if (k < kDeepMinK) k = kDeepMinK;
  if (k < k32) k = k32;
  if (k > 16) k = 16;
  *K = k;
  *W = (D + 32 * k - 1) / (32 * k);
}

// Warps a block of sgm_deep_kernel at K depths a lane may have (its
// launch bound): 32 at K = 16, else kDeepWarps (deep_shape).
__host__ __device__ constexpr int deep_max_warps(int K) {
  return K >= 16 ? kDeepMaxWarps : kDeepWarps;
}

// Warp w's slice of a chain's D depths: the ceil(D / K) lane runs of K
// depths spread evenly over the W warps, the first (runs % W) one run
// more, so that no warp holds a stub (cuda_agg.deep_slices mirrors it).
// Its first depth, and its runs: lanes 0 .. runs - 1 hold depths.
__device__ __forceinline__ void deep_slice(int D, int K, int W, int w,
                                           int* first, int* runs) {
  const int R = (D + K - 1) / K, q = R / W, rem = R % W;
  *runs = q + (w < rem ? 1 : 0);
  *first = (w * q + min(w, rem)) * K;
}

// sgm_deep_kernel's ring a warp: rows of 32 K elements and the 16 bytes
// that an unaligned start adds (fill_cover, copy_words), a multiple of 16
// bytes, as PathRing's; as many positions (2 to 32) as hold kDeepRingBytes
// of what a step reads (kDeepRingBytes16 at K = 16, where a chain's block
// has 4 to 32 warps: at [640, 640, 2048] 8 KB a warp left fewer blocks
// resident than the launch's 1279 chains, PERF.md), and no more than keep
// deep_max_warps(K) warps' rings within a block's shared memory.
template <typename T, int K, bool kAdd>
struct DeepRing {
  static constexpr int kArrays = kAdd ? 2 : 1;
  static constexpr int kRow = 32 * K + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStageBytes =
      kArrays * kRow * static_cast<int>(sizeof(T));
  static constexpr int kWant =
      (K >= 16 ? kDeepRingBytes16 : kDeepRingBytes) /
      (32 * K * static_cast<int>(sizeof(T)) * kArrays);
  static constexpr int kFit = 200 * 1024 / (deep_max_warps(K) * kStageBytes);
  static constexpr int kMost = kWant < kFit ? kWant : kFit;
  static constexpr int kStages = kMost < 2 ? 2 : (kMost > 32 ? 32 : kMost);
  static constexpr int kWarpBytes = kStages * kStageBytes;
};

// A lane's run of K elements (K sizeof(T) a multiple of 4 bytes) in the
// widest pieces of 16, 8 or 4 bytes that divide it: a run that starts on
// a multiple of its own size takes no split access.
template <typename T, int K>
struct RunPiece {
  static constexpr int kBytes = K * static_cast<int>(sizeof(T));
  static constexpr int kPiece =
      kBytes % 16 == 0 ? 16 : (kBytes % 8 == 0 ? 8 : 4);
  static constexpr int kWords = kPiece / 4;
  static constexpr int kCount = kBytes / kPiece;
};

// Depths [d0, d0 + K) of a run of n from v to p: whole pieces where vec
// and the lane's K lie inside n, else one element at a time (none past n).
template <typename T, int K>
__device__ __forceinline__ void store_run(T* p, const int (&v)[K], int d0,
                                          int n, bool vec) {
  using P = RunPiece<T, K>;
  if (vec && d0 + K <= n) {
#pragma unroll
    for (int c = 0; c < P::kCount; ++c) {
      uint32_t wd[P::kWords];
#pragma unroll
      for (int j = 0; j < P::kWords; ++j) {
        const int e = c * P::kWords + j;
        if constexpr (sizeof(T) == 4) {
          wd[j] = static_cast<uint32_t>(v[e]);
        } else {
          wd[j] = (static_cast<uint32_t>(v[2 * e]) & 0xffffu) |
                  (static_cast<uint32_t>(v[2 * e + 1]) << 16);
        }
      }
      uint32_t* q = reinterpret_cast<uint32_t*>(p) + c * P::kWords;
      if constexpr (P::kWords == 4) {
        *reinterpret_cast<uint4*>(q) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      } else if constexpr (P::kWords == 2) {
        *reinterpret_cast<uint2*>(q) = make_uint2(wd[0], wd[1]);
      } else {
        *q = wd[0];
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (d0 + k < n) p[k] = static_cast<T>(v[k]);
}

// Where a ring row filled by fill_cover from src holds the run: src's
// element offset past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int cover_start(const T* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) %
                          (16 / sizeof(T)));
}

// A depth run of n elements from src into a ring row (16-byte aligned,
// at least cover_start(src) + n elements rounded up to 16 bytes) by
// cp.async, in the 16-byte pieces that cover it from the boundary at or
// below src (the lanes take them in turn), so that a run anywhere keeps
// its loads in flight as aligned ones do; the row then holds the run from
// element cover_start(src). A piece that would pass `end`, the end of the
// launch's volumes, is copied an element at a time up to it. Commits no
// copy group.
template <typename T>
__device__ __forceinline__ void fill_cover(T* dst, const T* src, int n,
                                           const T* end, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  const T* base = src - cover_start(src);
  const int pieces = (cover_start(src) + n + kPer - 1) / kPer;
  for (int c = lane; c < pieces; c += 32) {
    const T* p = base + c * kPer;
    if (p + kPer <= end) {
      cp_async16(dst + c * kPer, p);
    } else {
      for (int e = 0; e < kPer && p + e < end; ++e) dst[c * kPer + e] = p[e];
    }
  }
}

// A lane's K elements of one position (its costs, or an accumulator's) in
// registers: int32 one a register, int16 two to a register (unpacked as
// they are used, so that the 16-depth forms hold 8 registers and not 16).
template <typename T, int K>
struct RunRegs {
  static constexpr int kRegs = sizeof(T) == 2 ? K / 2 : K;
  uint32_t r[kRegs];
  // Depths [d0, d0 + K) of a run of n at p: pieces where vec and the
  // lane's K lie inside n, else one element at a time (0 past n).
  __device__ __forceinline__ void load(const T* p, int d0, int n, bool vec) {
    using P = RunPiece<T, K>;
    if (vec && d0 + K <= n) {
#pragma unroll
      for (int c = 0; c < P::kCount; ++c) {
        uint32_t wd[P::kWords];
        load_piece<P::kWords>(
            reinterpret_cast<const int16_t*>(p) + c * 2 * P::kWords, wd);
#pragma unroll
        for (int j = 0; j < P::kWords; ++j) r[c * P::kWords + j] = wd[j];
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = d0 + k < n ? static_cast<int>(p[k]) : 0;
      if constexpr (sizeof(T) == 4) {
        r[k] = static_cast<uint32_t>(v);
      } else if (k & 1) {
        r[k >> 1] |= static_cast<uint32_t>(v) << 16;
      } else {
        r[k >> 1] = static_cast<uint32_t>(v) & 0xffffu;
      }
    }
  }
  __device__ __forceinline__ int at(int k) const {
    if constexpr (sizeof(T) == 4) {
      return static_cast<int>(r[k]);
    } else {
      return (k & 1) ? static_cast<int>(r[k >> 1]) >> 16
                     : static_cast<int>(static_cast<int16_t>(r[k >> 1] &
                                                             0xffffu));
    }
  }
};

// The sums of two 16-byte pieces, element by element, wrapping as the
// elements do (int16: two to a word, one SIMD add).
template <typename T>
__device__ __forceinline__ int4 add_piece(int4 a, int4 b) {
  if constexpr (sizeof(T) == 2) {
    return make_int4(
        static_cast<int>(__vadd2(static_cast<unsigned>(a.x), b.x)),
        static_cast<int>(__vadd2(static_cast<unsigned>(a.y), b.y)),
        static_cast<int>(__vadd2(static_cast<unsigned>(a.z), b.z)),
        static_cast<int>(__vadd2(static_cast<unsigned>(a.w), b.w)));
  } else {
    return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

// Element j (a constant) of a 16-byte piece of T.
template <typename T>
__device__ __forceinline__ T piece_at(const int4& v, int j) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  const int q = j / kPerWord;
  const unsigned wd =
      static_cast<unsigned>(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
  if constexpr (sizeof(T) == 4) {
    return static_cast<T>(wd);
  } else {
    return static_cast<T>((j & 1) ? wd >> 16 : wd & 0xffffu);
  }
}

// A staged run of n elements, held from element `mis` of st (16-byte
// aligned) on, out to dst, where dst - mis is 16-byte aligned, plus (kAcc)
// the run at acc (the accumulator's, in its ring row): the lanes take the
// 16-byte pieces in turn, each read whole (st's and acc's rows hold whole
// pieces) and written whole where the run covers it. Without acc the
// run's first and last pieces go out element by element from the piece's
// registers, unrolled. With acc they, and every piece where acc is not
// aligned as st is, go an element at a time (a piece's registers there
// cost the 1024-thread in-place form 36 bytes of spill, PERF.md). The sum
// never holds a lane's registers.
template <typename T, bool kAcc>
__device__ __forceinline__ void stage_out(const T* st, int mis, int n,
                                          T* dst, const T* acc, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  T* base = dst - mis;
  const int end = mis + n;
  if constexpr (kAcc) {
    const T* abase = acc - mis;  // abase[e] is added to st[e]
    const bool whole = reinterpret_cast<uintptr_t>(abase) % 16 == 0;
    for (int c = lane; c * kPer < end; c += 32) {
      const int lo = c * kPer;
      if (whole && lo >= mis && lo + kPer <= end) {
        reinterpret_cast<int4*>(base)[c] =
            add_piece<T>(reinterpret_cast<const int4*>(st)[c],
                         reinterpret_cast<const int4*>(abase)[c]);
      } else {
        for (int e = max(lo, mis); e < min(lo + kPer, end); ++e)
          base[e] = static_cast<T>(st[e] + abase[e]);
      }
    }
  } else {
    for (int c = lane; c * kPer < end; c += 32) {
      const int lo = c * kPer;
      const int4 v = reinterpret_cast<const int4*>(st)[c];
      if (lo >= mis && lo + kPer <= end) {
        reinterpret_cast<int4*>(base)[c] = v;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (lo + j >= mis && lo + j < end) base[lo + j] = piece_at<T>(v, j);
      }
    }
  }
}

// The chain's step barrier (kDeepBarrier): all W warps of the block.
__device__ __forceinline__ void deep_barrier() {
  if constexpr (kDeepBarrier == 1) {
    asm volatile("bar.sync 1, %0;" ::"r"(blockDim.x) : "memory");
  } else {
    __syncthreads();
  }
}

// One path of B problems in one direction at K depths a lane, one chain a
// block of W = blockDim.x / 32 warps (the design is at the head of this
// file). Chains, storage (kAdd) and modes as for sgm_path_kernel. a16:
// the strides are multiples of 16 bytes and cost and out 16-byte aligned,
// so a warp's slice that starts and ends on 16 bytes fills its ring in
// 16-byte pieces (otherwise the 4-byte words that cover it); vec: the
// strides and out are aligned to RunPiece's pieces, so a lane's run of out
// is written in them.
template <typename T, int K, bool kAdd>
__global__ void __launch_bounds__(deep_max_warps(K) * 32)
    sgm_deep_kernel(const T* __restrict__ cost,
                    const int32_t* __restrict__ inten, T* out, int B, int X,
                    int L, int D, long long vb, long long vx, long long vl,
                    long long ib, long long ix, long long il, int reverse,
                    int shift, int p1, int p2, bool a16, bool vec) {
  using Ring = DeepRing<T, K, kAdd>;
  using Run = RunPiece<T, K>;
  constexpr int S = Ring::kStages, A = Ring::kArrays, R = Ring::kRow;
  // The covering pieces fill int16 rings (kDeepFill 2), fill_run int32's.
  constexpr bool kCover =
      kDeepFill == 1 || (kDeepFill == 2 && sizeof(T) == 2);
  const bool stage =
      (kDeepStageOut >= 1 && Run::kBytes > 16) ||
      (kDeepStageOut == 2 &&
       !(vec && (Run::kBytes == 4 || Run::kBytes == 8 || Run::kBytes == 16)));
  extern __shared__ __align__(16) unsigned char smem_raw[];  // the rings
  __shared__ int p2a_tab[256];  // P2a by |dI| below 256
  // [parity][warp]: each warp's minimum of the line it computed at a step
  // of that parity, and the line at its first and its last depth.
  __shared__ int s_min[2][kDeepMaxWarps];
  __shared__ int s_lo[2][kDeepMaxWarps];
  __shared__ int s_hi[2][kDeepMaxWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  // [stage][cost, acc][d], this warp's
  T* ring = reinterpret_cast<T*>(smem_raw) + w * (S * A * R);
  fill_p2a(p2a_tab, p1, p2);
  __syncthreads();
  const long long n_chains = shift ? static_cast<long long>(L) + X - 1
                                   : static_cast<long long>(L);
  const long long b = blockIdx.x / n_chains;
  const long long c = blockIdx.x - b * n_chains;
  int t0 = 0;
  int l0;
  if (c < L) {
    l0 = static_cast<int>(c);
  } else {
    t0 = static_cast<int>(c - L + 1);
    l0 = shift > 0 ? 0 : L - 1;
  }
  int n = X - t0;
  if (shift > 0) n = min(n, L - l0);
  if (shift < 0) n = min(n, l0 + 1);
  const long long x0 = reverse ? X - 1 - t0 : t0;
  const long long step = (reverse ? -vx : vx) + shift * vl;
  const int32_t* ic = inten + b * ib + x0 * ix + l0 * il;
  const long long istep = (reverse ? -ix : ix) + shift * il;
  int ws = 0, runs = 0;
  deep_slice(D, K, W, w, &ws, &runs);
  const int wn = min(runs * K, D - ws);  // this warp's depths
  const T* cc = cost + b * vb + x0 * vx + l0 * vl + ws;
  T* co = out + b * vb + x0 * vx + l0 * vl + ws;
  const T* ca = kAdd ? co : nullptr;  // in place: read before written
  constexpr int kPer = 16 / sizeof(T);
  const bool async16 = a16 && ws % kPer == 0 && wn % kPer == 0;
  const T* cend = cost + B * vb;  // the launch's volumes' ends
  const T* aend = out + B * vb;
  const int p2min = p1 * 3 / 2;
  auto row = [&](int s, int a) { return ring + ((s % S) * A + a) * R; };
  auto fill = [&](int s) {
    if (s < n) {
      const long long go = s * step;
      if constexpr (kCover) {
        fill_cover<T>(row(s, 0), cc + go, wn, cend, lane);
        if constexpr (kAdd) fill_cover<T>(row(s, A - 1), ca + go, wn, aend,
                                          lane);
      } else {
        fill_run<T, true>(row(s, 0), kAdd ? row(s, A - 1) : nullptr,
                          cc + go, kAdd ? ca + go : nullptr, wn, async16,
                          cend, aend, lane);
      }
    }
    cp_async_commit();
  };
  // Where the ring row filled from src holds the run.
  auto start_of = [&](const T* src) {
    if constexpr (kCover) return cover_start<T>(src);
    return ring_start<T, true>(src, async16);
  };
  // Intensities of steps [32 c, 32 c + 32), lane j holding step 32 c + j.
  auto inten_run = [&](int q) {
    const int s = q * 32 + lane;
    return s < n ? ic[s * istep] : 0;
  };
  auto p2a_of = [&](int i_cur, int i_prev) {
    const int d = abs(i_cur - i_prev);
    return d < 256 ? p2a_tab[d] : max(p2min, p2 / (d + 1));
  };

  for (int s = 0; s < S - 1; ++s) fill(s);
  int run = inten_run(0), next_run = inten_run(1);
  const int d0 = lane * K;  // this lane's first depth in the slice
  int prev[K];  // the line, updated in place
  int prev_i = 0;
  for (int t = 0; t < n; ++t) {
    __syncwarp();  // every lane has read the stage of step t - 1
    fill(t + S - 1);  // into that stage
    cp_async_wait<S - 1>();  // this lane's copies for step t
    __syncwarp();  // and every other lane's
    if (t > 0 && (t & 31) == 0) {
      run = next_run;
      next_run = inten_run((t >> 5) + 1);
    }
    const int it = __shfl_sync(kFull, run, t & 31);
    const long long go = t * step;
    const int sc = start_of(cc + go);
    RunRegs<T, K> cur;
    cur.load(row(t, 0) + sc + d0, d0, wn,
             (sc * static_cast<int>(sizeof(T))) % Run::kPiece == 0);
    int mn = kBig;
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        prev[k] = d0 + k < wn ? cur.at(k) : kBig;
        mn = min(mn, prev[k]);
      }
    } else {
      // The block's line of step t - 1: its minimum and the depths just
      // past this warp's ends, published by every warp before the barrier.
      const int par = t & 1;
      deep_barrier();
      const int m =
          __reduce_min_sync(kFull, lane < W ? s_min[par][lane] : kBig);
      int dn = __shfl_up_sync(kFull, prev[K - 1], 1);     // prev[d0 - 1]
      int right = __shfl_down_sync(kFull, prev[0], 1);    // prev[d0 + K]
      if (lane == 0) dn = w > 0 ? s_hi[par][w - 1] : kBig;
      if (lane == runs - 1) right = w + 1 < W ? s_lo[par][w + 1] : kBig;
      const int mp = m + p2a_of(it, prev_i);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = prev[k];
        const int up = k == K - 1 ? right : prev[k + 1];
        int v = sgm_step(cur.at(k), a, dn, up, p1, mp, m);
        if (d0 + k >= wn) v = kBig;
        dn = a;
        prev[k] = v;
        mn = min(mn, v);
      }
    }
    // Published for step t + 1: slot (t + 1) & 1 is written again at step
    // t + 2, after the barrier that every reader of it at t + 1 has passed.
    mn = __reduce_min_sync(kFull, mn);
    if (lane == 0) {
      s_min[(t + 1) & 1][w] = mn;
      s_lo[(t + 1) & 1][w] = prev[0];
    }
    if (lane == runs - 1) s_hi[(t + 1) & 1][w] = prev[K - 1];
    // The accumulator's run of this position in its ring row.
    const int sa = kAdd ? start_of(ca + go) : 0;
    const T* acc_run = kAdd ? row(t, A - 1) + sa : nullptr;
    if (stage) {
      // Through the cost row just read, from the element that puts the
      // run's 16-byte boundaries on the row's, so that consecutive lanes
      // write consecutive pieces; the accumulator is added on the way
      // out.
      T* st = row(t, 0);
      const int mis = cover_start<T>(co + go);
      __syncwarp();  // every lane has read the stage
      store_run<T, K>(st + mis + d0, prev, d0, wn,
                      (mis * static_cast<int>(sizeof(T))) % Run::kPiece == 0);
      __syncwarp();
      stage_out<T, kAdd>(st, mis, wn, co + go, acc_run, lane);
    } else if constexpr (kAdd) {
      RunRegs<T, K> av;
      av.load(acc_run + d0, d0, wn,
              (sa * static_cast<int>(sizeof(T))) % Run::kPiece == 0);
      int sum[K];
#pragma unroll
      for (int k = 0; k < K; ++k) sum[k] = prev[k] + av.at(k);
      store_run<T, K>(co + go + d0, sum, d0, wn, vec);
    } else {
      store_run<T, K>(co + go + d0, prev, d0, wn, vec);
    }
    prev_i = it;
  }
}

template <typename T, int K, bool kAdd>
cudaError_t launch_deep(const void* cost, const void* inten, void* out,
                        int B, int X, int L, int D, long long vb,
                        long long vx, long long vl, long long ib,
                        long long ix, long long il, int reverse, int shift,
                        int p1, int p2, cudaStream_t stream) {
  if constexpr (K < kDeepMinK) {
    return cudaErrorInvalidValue;  // deep_shape gives no such K
  } else {
    using Ring = DeepRing<T, K, kAdd>;
    const int W = (D + 32 * K - 1) / (32 * K);
    if (W > deep_max_warps(K)) return cudaErrorInvalidConfiguration;
    const int smem = W * Ring::kWarpBytes;
    cudaError_t e = cudaFuncSetAttribute(
        sgm_deep_kernel<T, K, kAdd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    constexpr long long kPer = 16 / sizeof(T);
    const bool a16 = vb % kPer == 0 && vx % kPer == 0 && vl % kPer == 0 &&
                     reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    constexpr int kPiece = RunPiece<T, K>::kPiece;
    constexpr long long kPe = kPiece / sizeof(T);
    const bool vec = vb % kPe == 0 && vx % kPe == 0 && vl % kPe == 0 &&
                     reinterpret_cast<uintptr_t>(out) % kPiece == 0;
    const long long n_chains =
        shift ? static_cast<long long>(L) + X - 1 : static_cast<long long>(L);
    const long long blocks = static_cast<long long>(B) * n_chains;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    sgm_deep_kernel<T, K, kAdd>
        <<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(
            static_cast<const T*>(cost), static_cast<const int32_t*>(inten),
            static_cast<T*>(out), B, X, L, D, vb, vx, vl, ib, ix, il, reverse,
            shift, p1, p2, a16, vec);
    return cudaGetLastError();
  }
}

template <typename T, bool kAdd>
cudaError_t launch_deep_k(const void* cost, const void* inten, void* out,
                          int B, int X, int L, int D, long long vb,
                          long long vx, long long vl, long long ib,
                          long long ix, long long il, int reverse, int shift,
                          int p1, int p2, cudaStream_t s) {
  int W = 0, K = 0;
  deep_shape(D, &W, &K);
  switch (K) {
    case 2: return launch_deep<T, 2, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 4: return launch_deep<T, 4, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 6: return launch_deep<T, 6, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 8: return launch_deep<T, 8, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 10: return launch_deep<T, 10, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 12: return launch_deep<T, 12, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    case 14: return launch_deep<T, 14, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
    default: return launch_deep<T, 16, kAdd>(cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift, p1, p2, s);
  }
}

}  // namespace

// One path of B problems in one direction. elem_bytes = 2: int16
// volumes, out += path costs in place (add = 1; rows 1-3 beyond the other
// kernels' reach), or out = path costs (add = 0; the first launch of an
// 8-path sum on the per-path route). elem_bytes = 4 with add = 0: int32
// volumes, out = path costs (row 5). 1 <= D <= kPathMaxD: the depths per
// lane K = ceil(D / 32) is a template parameter, instantiated for 1-4, 8
// and 16.
// cost/out: depth stride 1 and element strides (vb, vx, vl) for problem,
// scan position and line; inten: int32 with strides (ib, ix, il). shift is
// 0 (straight) or +-1 (diagonal: the line index moves by shift per scan
// step). Returns the cudaError_t of the launch.
extern "C" int sgm_agg_path(const void* cost, const void* inten, void* out,
                            int elem_bytes, int add, int B, int X, int L,
                            int D, long long vb, long long vx, long long vl,
                            long long ib, long long ix, long long il,
                            int reverse, int shift, int p1, int p2,
                            void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > kPathMaxD || shift < -1 ||
      shift > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && add)
    return static_cast<int>(launch_path_k<int16_t, true>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  if (elem_bytes == 2 && !add)
    return static_cast<int>(launch_path_k<int16_t, false>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  if (elem_bytes == 4 && !add)
    return static_cast<int>(launch_path_k<int32_t, false>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// sgm_agg_path's work for kPathMaxD < D <= kDeepMaxD (any 1 <= D <=
// kDeepMaxD is taken): one path of B problems in one direction, one block
// of W warps of K depths a lane per chain (deep_shape). Arguments,
// storage and result as for sgm_agg_path.
extern "C" int sgm_agg_deep(const void* cost, const void* inten, void* out,
                            int elem_bytes, int add, int B, int X, int L,
                            int D, long long vb, long long vx, long long vl,
                            long long ib, long long ix, long long il,
                            int reverse, int shift, int p1, int p2,
                            void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > kDeepMaxD || shift < -1 ||
      shift > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && add)
    return static_cast<int>(launch_deep_k<int16_t, true>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  if (elem_bytes == 2 && !add)
    return static_cast<int>(launch_deep_k<int16_t, false>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  if (elem_bytes == 4 && !add)
    return static_cast<int>(launch_deep_k<int32_t, false>(
        cost, inten, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, shift,
        p1, p2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// One straight sweep of B int16 problems (rows 2 and 3): out = acc + path
// costs, in place where acc == out, or out = path costs where acc is null.
// Strides as for sgm_agg_path. Returns the cudaError_t of the launch.
extern "C" int sgm_agg_line(const void* cost, const void* inten,
                            const void* acc, void* out, int B, int X, int L,
                            int D, long long vb, long long vx, long long vl,
                            long long ib, long long ix, long long il,
                            int reverse, int p1, int p2, void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > kPathMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return static_cast<int>(launch_line<1>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
    case 2: return static_cast<int>(launch_line<2>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
    case 3: return static_cast<int>(launch_line<3>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
    case 4: return static_cast<int>(launch_line<4>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
    case 5: case 6: case 7: case 8:
      return static_cast<int>(launch_line<8>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
    default: return static_cast<int>(launch_line<16>(cost, inten, acc, out, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, p1, p2, s));
  }
}

// The vertical sweep kernel's geometry for D <= kPathMaxD depths on the
// current device: lines per block (at D > 128 the most a block holds: at
// most kTile, within the device's shared memory per block; 0 where one
// line does not fit), edge-buffer words per block, and the most blocks the
// device keeps resident at once (the largest cooperative grid; at D > 128
// one block an SM, as the wrapper plans them: the SM count).
extern "C" int sgm_sweep3_geometry(int D, int* tile, int* edge_words,
                                   int* resident) {
  if (D < 1 || D > kPathMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (D > kSweepMaxD) {
    const int K = D <= 256 ? 8 : 16;
    const int S = K == 8 ? Sweep3<8>::kStages : Sweep3<16>::kStages;
    *tile = 0;
    for (int n = kTile; n >= 1; --n) {
      if (sweep3_layout(n, K, S).bytes > optin) continue;
      e = K == 8 ? sweep3_per_sm<8>(n, &per_sm)
                 : sweep3_per_sm<16>(n, &per_sm);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (per_sm >= 1) {
        *tile = n;
        break;
      }
    }
    *edge_words = 2 * 2 * 32 * K;
    *resident = sms;
    return static_cast<int>(cudaSuccess);
  }
  switch ((D + 31) / 32) {
    case 1: e = sweep3_per_sm<1>(kTile, &per_sm); break;
    case 2: e = sweep3_per_sm<2>(kTile, &per_sm); break;
    case 3: e = sweep3_per_sm<3>(kTile, &per_sm); break;
    default: e = sweep3_per_sm<4>(kTile, &per_sm); break;
  }
  *tile = kTile;
  *edge_words = 2 * 2 * kEdge;
  *resident = per_sm * sms;
  return static_cast<int>(e);
}

// One sweep of the distinct shifts in `paths` (bit 0: 0, bit 1: +1,
// bit 2: -1) over B int16 problems, out += path costs in place (rows 1-4),
// as one cooperative launch of B * ceil(L / lines) blocks, which must all
// be resident (sgm_sweep3_geometry). `lines` lines a block at D > 128 (at
// most the geometry's tile); at D <= 128 every block holds kTile and
// `lines` is not read. Strides as for sgm_agg_path; edge as
// sgm_sweep3_kernel describes it (all -1). Returns the cudaError_t of the
// launch.
extern "C" int sgm_agg_sweep3(const void* cost, const void* inten, void* out,
                              void* edge, int B, int X, int L,
                              int D, long long vb, long long vx, long long vl,
                              long long ib, long long ix, long long il,
                              int reverse, int paths, int p1, int p2,
                              int lines, void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > kPathMaxD || paths < 1 ||
      paths > 7 || (D > kSweepMaxD && (lines < 1 || lines > kTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return static_cast<int>(launch_sweep3<1>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
    case 2: return static_cast<int>(launch_sweep3<2>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
    case 3: return static_cast<int>(launch_sweep3<3>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
    case 4: return static_cast<int>(launch_sweep3<4>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
    case 5: case 6: case 7: case 8:
      return static_cast<int>(launch_sweep3<8>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
    default: return static_cast<int>(launch_sweep3<16>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, s));
  }
}

// The two-walk form of the vertical sweep kernel (kBidir) at D <=
// kSweepMaxD on the current device: edge-buffer words per block (both
// walks' slots), and the most blocks of `lines` lines (1 to
// kBidirMaxLines) it keeps resident at once (the largest cooperative
// grid).
extern "C" int sgm_sweep3_bidir_geometry(int D, int lines, int* edge_words,
                                         int* resident) {
  if (D < 1 || D > kSweepMaxD || lines < 1 || lines > kBidirMaxLines)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  switch ((D + 31) / 32) {
    case 1: e = sweep3_per_sm<1, true>(lines, &per_sm); break;
    case 2: e = sweep3_per_sm<2, true>(lines, &per_sm); break;
    case 3: e = sweep3_per_sm<3, true>(lines, &per_sm); break;
    default: e = sweep3_per_sm<4, true>(lines, &per_sm); break;
  }
  *edge_words = 2 * 2 * 2 * kEdge;
  *resident = per_sm * sms;
  return static_cast<int>(e);
}

// The forward and the backward sweep of the distinct shifts in `paths`
// (bit 0: 0, bit 1: +1, bit 2: -1) over B int16 problems at D <=
// kSweepMaxD, out += both sweeps' path costs in place (row 3), as one
// cooperative launch of B * ceil(L / lines) blocks of `lines` lines (1 to
// kBidirMaxLines) walked in both directions, which must all be resident
// (sgm_sweep3_bidir_geometry). Strides as for sgm_agg_path; edge as
// sgm_sweep3_kernel describes it for kBidir (all -1). Returns the
// cudaError_t of the launch.
extern "C" int sgm_agg_sweep3_bidir(const void* cost, const void* inten,
                                    void* out, void* edge, int B, int X,
                                    int L, int D, long long vb, long long vx,
                                    long long vl, long long ib, long long ix,
                                    long long il, int paths, int p1, int p2,
                                    int lines, void* stream) {
  if (B < 1 || X < 1 || L < 1 || D < 1 || D > kSweepMaxD || paths < 1 ||
      paths > 7 || lines < 1 || lines > kBidirMaxLines)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return static_cast<int>(launch_sweep3<1, true>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, 0, paths, p1, p2, lines, s));
    case 2: return static_cast<int>(launch_sweep3<2, true>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, 0, paths, p1, p2, lines, s));
    case 3: return static_cast<int>(launch_sweep3<3, true>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, 0, paths, p1, p2, lines, s));
    default: return static_cast<int>(launch_sweep3<4, true>(cost, inten, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, 0, paths, p1, p2, lines, s));
  }
}

// The deep sweep kernel's geometry for kPathMaxD < D <= kDeepMaxD on the
// current device: the most lines a block of a sweep with a diagonal holds
// (at most kDeepSweepDiagThreads threads and the device's shared memory
// per block, one block resident per SM; 0 where one line does not fit),
// the edge-buffer words per block, and the device's SM count. A launch
// with a diagonal holds at most one block per SM (cuda_agg.plan_route).
extern "C" int sgm_deep_sweep_geometry(int D, int* max_lines,
                                       int* edge_words, int* sms) {
  if (D <= kPathMaxD || D > kDeepMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int W = 0, K = 0;
  deep_sweep_shape(D, true, &W, &K);
  *edge_words = 8 * (K * 32 * W + 32);
  *max_lines = 0;
  for (int n = kDeepSweepDiagThreads / (32 * W); n >= 1; --n) {
    const int smem =
        deep_sweep_layout(n, W, K, kDeepSweepStages, true).bytes;
    if (smem > optin) continue;
    const void* fn = nullptr;
    switch (K) {
      case 6: fn = (const void*)sgm_deep_sweep_kernel<6, true, true>; break;
      case 8: fn = (const void*)sgm_deep_sweep_kernel<8, true, true>; break;
      case 10: fn = (const void*)sgm_deep_sweep_kernel<10, true, true>; break;
      case 12: fn = (const void*)sgm_deep_sweep_kernel<12, true, true>; break;
      case 14: fn = (const void*)sgm_deep_sweep_kernel<14, true, true>; break;
      default: fn = (const void*)sgm_deep_sweep_kernel<16, true, true>; break;
    }
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        n * 32 * W, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm >= 1) {
      *max_lines = n;
      break;
    }
  }
  return static_cast<int>(cudaSuccess);
}

// One sweep of the distinct shifts in `paths` (bit 0: 0, bit 1: +1, bit 2:
// -1) over B int16 problems at kPathMaxD < D <= kDeepMaxD depths: out =
// acc + path costs, in place where acc == out, or out = path costs where
// acc is null (rows 1-4). `lines` lines of a problem per block. With a
// diagonal the launch is cooperative: at most one block per SM, `lines` at
// most sgm_deep_sweep_geometry's, and edge as sgm_deep_sweep_kernel
// describes it (all -1); straight only, any grid and a null edge. Strides
// as for sgm_agg_path. Returns the cudaError_t of the launch.
extern "C" int sgm_agg_deep_sweep(const void* cost, const void* inten,
                                  const void* acc, void* out, void* edge,
                                  int B, int X, int L, int D, long long vb,
                                  long long vx, long long vl, long long ib,
                                  long long ix, long long il, int reverse,
                                  int paths, int p1, int p2, int lines,
                                  void* stream) {
  const bool diag = (paths & 6) != 0;
  int W = 0, K = 0;
  deep_sweep_shape(D, diag, &W, &K);
  if (B < 1 || X < 1 || L < 1 || D <= kPathMaxD || D > kDeepMaxD ||
      paths < 1 || paths > 7 || lines < 1 ||
      lines * 32 * W > (diag ? kDeepSweepDiagThreads : kDeepSweepThreads) ||
      (diag && edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag) {
    switch (K) {
      case 6: return static_cast<int>(launch_deep_sweep<6, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
      case 8: return static_cast<int>(launch_deep_sweep<8, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
      case 10: return static_cast<int>(launch_deep_sweep<10, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
      case 12: return static_cast<int>(launch_deep_sweep<12, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
      case 14: return static_cast<int>(launch_deep_sweep<14, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
      default: return static_cast<int>(launch_deep_sweep<16, true>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
    }
  }
  switch (K) {
    case 10: return static_cast<int>(launch_deep_sweep<10, false>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
    case 12: return static_cast<int>(launch_deep_sweep<12, false>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
    case 14: return static_cast<int>(launch_deep_sweep<14, false>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
    default: return static_cast<int>(launch_deep_sweep<16, false>(cost, inten, acc, out, edge, B, X, L, D, vb, vx, vl, ib, ix, il, reverse, paths, p1, p2, lines, W, s));
  }
}
