// K1 for Hopper: R whole OM(1) agreement rounds per launch, plain or
// mutating (scenario) mode, for one batch or for a coalesced serving
// cohort of independent slots (slot mode).
//
// Replaces ba_tpu/ops/scenario_step.py::_megastep_kernel (the Pallas TPU
// kernel, plain, scenario and slot modes).  Bit-exact against the port's
// plain engine (ba_tpu_torch/parallel/pipeline.py, _pipeline_scan,
// _scenario_scan and coalesced_megastep), which is bit-exact against the
// reference's XLA scan core under jax's partitionable threefry mode:
//   kr = tf(base, (0, ctr + r)), ki = tf(kr, (0, b)) (slot mode: base is
//   slot b's own key and ki = tf(kr, (0, 0)), the key its B = 1 run uses),
//   ka = tf(ki, (0, 0)), kb = tf(ki, (0, 1)),
//   round-1 coin j: bit j / nw1 of word j % nw1 of ka, nw1 = ceil(n / 32);
//   cube coin (asker i, responder j), e = i * n + j: bit e / nw2 of word
//   e % nw2 of kb, nw2 = ceil(n * n / 32); word w = y0 ^ y1 of tf(k, (0, w)).
//
// What bounds it: integer operations.  There is no matrix product; the
// work is threefry2x32 (about 80 int32 operations a word) for the coins
// of faulty responders, plus the tallies.  The state moved is B * n bytes
// a plane per dispatch, which is small next to that.
//
// What the design does about it:
// - one thread block per instance, the R-round loop inside the block, the
//   instance's planes (alive, faulty, strategy, received) in shared memory;
// - only the words that hold a coin that decides a vote are drawn, each
//   at most once an instance and round, and every bit of a word is used
//   (coins.cuh): a needed coin is one where a counted asker meets an
//   alive faulty non-leader responder with a coin strategy other than
//   itself; honest answers and lie-table answers are counted once per
//   instance and shared by every asker;
// - where n is a multiple of 32 (every full-width cell: capacity 1024,
//   buckets padded to multiples of 128) a responder's coins to all n
//   askers lie in n / 32 words, one a column q; a warp takes a column, a
//   lane a responder, and a 32 x 32 bit transpose by shuffles hands lane k
//   the coins of asker k * n / 32 + q, which it pops: no atomics and no
//   division.  At n = 1024 a round draws ~32 u words (u coin responders)
//   instead of one word a coin (~520 u);
// - any other n: a warp takes 32 cube words at a time; lane k builds the
//   need of their bit k, a run of 32 coins of the row-major cube, from a
//   bitmap of the coin responders (a few operations a row it meets, not
//   one a coin), a transpose hands each lane its word's need, the lane
//   draws the word once, a second transpose hands lane k its run of coins
//   back, and the ATTACK coins of each row it meets go to that asker by a
//   shared-memory atomic; 32 words none of which holds a needed coin cost
//   their warp the need windows and one vote, no draw and no transpose.
//   The draws use a lane only where its word holds a needed coin, and
//   every group of 32 words is visited, so this path costs about the n²/32
//   words of the cube a round, not the words needed (at capacity 1000 it
//   runs near the time of one word a coin; PERF.md);
// - round-1 coins of a coin drawing faulty leader come 32 to a word;
// - the round keys are made once a block (thread 0, the round before);
// - per-round histogram and counter verdicts go through integer atomics
//   (exact, so the result does not depend on block order); a second
//   one-thread kernel folds them into cumulative counter rows;
// - slot mode touches no atomics across blocks: block b folds its own
//   counter block and writes its row of every round itself.  Its last
//   round also draws the coins of every dead asker, so that the
//   majorities it returns for all n generals are the reference's (a dead
//   general's majority is defined: it hears every alive responder); the
//   earlier rounds pay nothing for that.
// Every round is computed: nothing but the round-invariant keys is
// hoisted, and no decision is copied from round to round.

#include <cstdint>
#include <cuda_runtime.h>

#if defined(BA_COUNT_DRAWS)
// The counting build (chip_smoke.py builds it beside the kernel): every
// threefry word the kernel evaluates adds one here, read and cleared by
// ba_megastep_words_drawn.  The kernel's own build defines nothing.
__device__ unsigned long long ba_words_drawn;
#if defined(__CUDA_ARCH__)
#define COIN_DRAWN(k) atomicAdd(&ba_words_drawn, static_cast<unsigned long long>(k))
#endif
#endif

#include "coins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int RETREAT = 0;
constexpr int ATTACK = 1;
constexpr int UNDEFINED = 2;

// Per-round block scalars (shared memory).
enum Scalar {
  U_CNT, H_ATT, H_RET, KE_ATT, KE_RET, KO_ATT, KO_RET,
  TRAITOR, C_ATT, C_RET, C_UND, SEEN_LT, SEEN_HLT, DISOBEY, N_SCALARS
};

struct Params {
  int B, n, R;
  int C;                      // counter columns (slot mode): 3, or 5 with events
  bool slot;                  // a coalesced cohort: per-slot keys and counters
  const long long* key_data;  // [2] uint32 words held in int64 ([B, 2] in slot mode)
  const int* counter;         // schedule counter at entry (int32)
  const signed char* order;   // [B]
  int* leader;                // [B], updated in place
  unsigned char* faulty;      // [B, n] bool, updated in place
  unsigned char* alive;       // [B, n] bool, updated in place
  const int* ids;             // [B, n]
  signed char* strategy;      // [B, n] or null (plain mode: all RANDOM)
  const unsigned char* kill;  // [R, B, n] or null (plain mode)
  const unsigned char* revive;
  const signed char* set_faulty;
  const signed char* set_strategy;
  signed char* decisions;     // [R, B] or null
  int* leaders;               // [R, B] or null
  int* hist;                  // [R, 3], zeroed by the launcher (null in slot mode)
  int* verdicts;              // [R, 3]: equivocation, ic1, ic2; zeroed (null in slot mode)
  const int* counters_in;     // slot mode: [B, C] incoming blocks
  int* rows;                  // slot mode: [R, B, C] cumulative rows
  signed char* majorities;    // slot mode: [B, n], the last round's
};

// The strategy lie table: what a faulty sender with strategy s says to
// receiver index recv, or -1 where the strategy draws a coin (RANDOM and
// unknown ids).
__device__ __forceinline__ int lie_value(int s, int recv) {
  switch (s) {
    case 1: return ATTACK;                          // COLLUDE_ATTACK
    case 2: return RETREAT;                         // COLLUDE_RETREAT
    case 3: return UNDEFINED;                       // SILENT
    case 4: return (recv & 1) ? RETREAT : ATTACK;   // ADAPTIVE_SPLIT
    default: return -1;
  }
}

// Block-wide count of pred (every thread of the block must call it).
__device__ __forceinline__ void count(int* slot, bool pred, int lane) {
  const unsigned m = __ballot_sync(kFull, pred);
  if (lane == 0 && m) atomicAdd(slot, __popc(m));
}

__device__ __forceinline__ void bit_or(int* slot, int bits, int lane) {
  const unsigned v = __reduce_or_sync(kFull, (unsigned)bits);
  if (lane == 0 && v) atomicOr(slot, (int)v);
}

// The slot in a list of a value appended where pred holds (order across
// warps is free); -1 where it does not.
__device__ __forceinline__ int append(int* cnt, bool pred, int lane) {
  const unsigned m = __ballot_sync(kFull, pred);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(kFull, base, 0);
  return pred ? base + __popc(m & ((1u << lane) - 1u)) : -1;
}

// The 32 x 32 bit transpose of a warp's words (coins.cuh's stages).
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    x = transpose_stage(x, __shfl_xor_sync(kFull, x, s), lane, s);
  return x;
}

__global__ void __launch_bounds__(kThreads) megastep_kernel(Params p) {
  extern __shared__ int smem[];
  const int n = p.n;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool scenario = p.kill != nullptr;

  int* ones = smem;         // [n] attack coins each asker drew
  int* ulist = ones + n;    // [n] coin responders
  // [n] n a multiple of 32: each coin responder's column and bit as an
  // asker, (j mod Q) << 5 | j / Q; other n: the first nw1 words hold the
  // coin responders' bitmap (s_resp)
  int* ucol = ulist + n;
  uint32_t* s_resp = reinterpret_cast<uint32_t*>(ucol);
  unsigned char* s_alive = reinterpret_cast<unsigned char*>(ucol + n);
  unsigned char* s_faulty = s_alive + n;
  signed char* s_strat = reinterpret_cast<signed char*>(s_faulty + n);
  signed char* s_recv = s_strat + n;
  // 0: not counted (dead or leader), 1: honest, 2: faulty with a
  // lie-table row, 3: faulty drawing coins.
  unsigned char* s_kind = reinterpret_cast<unsigned char*>(s_recv + n);
  __shared__ int sc[N_SCALARS];
  __shared__ unsigned long long s_min;
  __shared__ uint32_t s_key[4];  // the round's ka, kb (thread 0's, a round ahead)

  const size_t row = static_cast<size_t>(b) * n;
  for (int j = tid; j < n; j += kThreads) {
    s_alive[j] = p.alive[row + j];
    s_faulty[j] = p.faulty[row + j];
    s_strat[j] = p.strategy ? p.strategy[row + j] : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < N_SCALARS; ++s) sc[s] = 0;
    s_min = ~0ull;
  }
  int leader = p.leader[b];
  const int order = p.order[b];
  const long long* kd = p.key_data + (p.slot ? 2 * b : 0);
  const uint32_t base0 = static_cast<uint32_t>(kd[0]);
  const uint32_t base1 = static_cast<uint32_t>(kd[1]);
  int cum[5];  // slot mode: this block's counter block (thread 0's)
  if (p.slot && tid == 0)
    for (int c = 0; c < p.C; ++c) cum[c] = p.counters_in[b * p.C + c];
  const uint32_t ctr0 = static_cast<uint32_t>(*p.counter);
  const int nw1 = (n + 31) / 32;
  const int nw2 = static_cast<int>((static_cast<long long>(n) * n + 31) / 32);
  const bool columns = n % 32 == 0;
  const int Q = n / 32;  // columns (n a multiple of 32)
  // ka, kb of round r: kr = tf(base, (0, ctr + r)), ki = tf(kr, (0, b))
  // (slot mode: (0, 0)), ka = tf(ki, (0, 0)), kb = tf(ki, (0, 1)).
  auto round_keys = [&](int r) {
    COIN_DRAWN(4);
    uint32_t kr0, kr1, ki0, ki1;
    tf2x32(base0, base1, 0u, ctr0 + static_cast<uint32_t>(r), kr0, kr1);
    tf2x32(kr0, kr1, 0u, p.slot ? 0u : static_cast<uint32_t>(b), ki0, ki1);
    tf2x32(ki0, ki1, 0u, 0u, s_key[0], s_key[1]);
    tf2x32(ki0, ki1, 0u, 1u, s_key[2], s_key[3]);
  };
  if (tid == 0) round_keys(0);
  __syncthreads();

  for (int r = 0; r < p.R; ++r) {
    if (scenario) {
      const size_t ev = (static_cast<size_t>(r) * p.B + b) * n;
      for (int j = tid; j < n; j += kThreads) {
        s_alive[j] = (s_alive[j] && !p.kill[ev + j]) || p.revive[ev + j];
        const int fset = p.set_faulty[ev + j];
        if (fset >= 0) s_faulty[j] = fset > 0;
        const int sset = p.set_strategy[ev + j];
        if (sset >= 0) s_strat[j] = static_cast<signed char>(sset);
      }
      __syncthreads();
      // Lowest alive id, first index on ties; an all-dead row elects 0.
      unsigned long long best = ~0ull;
      for (int j = tid; j < n; j += kThreads) {
        const int id = s_alive[j] ? p.ids[row + j] : 0x7fffffff;
        const unsigned long long key =
            (static_cast<unsigned long long>(static_cast<uint32_t>(id) ^
                                             0x80000000u) << 32) |
            static_cast<uint32_t>(j);
        best = key < best ? key : best;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, best, off);
        best = o < best ? o : best;
      }
      if (lane == 0) atomicMin(&s_min, best);
      __syncthreads();
      if (!s_alive[leader]) leader = static_cast<int>(s_min & 0xffffffffull);
    }

    const uint32_t ka0 = s_key[0], ka1 = s_key[1], kb0 = s_key[2], kb1 = s_key[3];
    const bool lf = s_faulty[leader];
    const int ls = s_strat[leader];
    // Slot mode's last round: every general but the leader asks.
    const bool all_ask = p.slot && r == p.R - 1;

    // A faulty leader drawing coins: its round-1 coins, 32 to a word, into
    // s_recv (read back by the classification below).
    if (lf && lie_value(ls, 0) < 0) {
      auto recipient = [&](int j) { return s_alive[j] && j != leader; };
      for (int w = tid; w < nw1; w += kThreads) {
        const uint32_t need = round1_need(w, n, nw1, recipient);
        if (!need) continue;
        const uint32_t y = coin_word(ka0, ka1, static_cast<uint32_t>(w));
        for (int k = 0, j = w; k < 32 && j < n; ++k, j += nw1)
          if ((need >> k) & 1u) s_recv[j] = static_cast<signed char>((y >> k) & 1u);
      }
      __syncthreads();
    }

    // Round 1 and the per-instance classification of responders.
    for (int base = 0; base < n; base += kThreads) {
      const int j = base + tid;
      const bool valid = j < n;
      int kind = 0, recv = order, ev = -1, ov = -1;
      bool traitor = false;
      if (valid) {
        const bool alive_j = s_alive[j];
        const bool faulty_j = s_faulty[j];
        traitor = alive_j && faulty_j;
        if (alive_j && j != leader) {
          if (lf) {
            const int v = lie_value(ls, j);
            recv = v >= 0 ? v : s_recv[j];
          }
          kind = 1;
          if (faulty_j) {
            ev = lie_value(s_strat[j], 0);
            ov = lie_value(s_strat[j], 1);
            kind = ev >= 0 ? 2 : 3;
          }
        }
        ones[j] = 0;
        s_recv[j] = static_cast<signed char>(recv);
        s_kind[j] = static_cast<unsigned char>(kind);
      }
      count(&sc[H_ATT], kind == 1 && recv == ATTACK, lane);
      count(&sc[H_RET], kind == 1 && recv == RETREAT, lane);
      count(&sc[KE_ATT], kind == 2 && ev == ATTACK, lane);
      count(&sc[KE_RET], kind == 2 && ev == RETREAT, lane);
      count(&sc[KO_ATT], kind == 2 && ov == ATTACK, lane);
      count(&sc[KO_RET], kind == 2 && ov == RETREAT, lane);
      count(&sc[TRAITOR], traitor, lane);
      const int slot = append(&sc[U_CNT], kind == 3, lane);
      if (columns && slot >= 0) {
        ulist[slot] = j;
        ucol[slot] = ((j % Q) << 5) | (j / Q);
      }
      if (!columns) {  // word (base + 32 warp) / 32 of the bitmap
        const unsigned bits = __ballot_sync(kFull, kind == 3);
        if (lane == 0 && base + 32 * warp < n) s_resp[(base >> 5) + warp] = bits;
      }
    }
    __syncthreads();

    // The coins, each word drawn once (coins.cuh).
    const int u = sc[U_CNT];
    auto asker = [&](int i) { return s_kind[i] != 0 || (all_ask && i != leader); };
    if (u > 0 && columns) {
      // A warp a column q, a lane a responder; after the transpose lane k
      // holds the coins of asker k * Q + q from 32 responders.
      for (int q = warp; q < Q; q += kWarps) {
        const int i = lane * Q + q;
        const uint32_t askers = __ballot_sync(kFull, asker(i));
        if (!askers) continue;
        int drawn = 0;
        for (int c0 = 0; c0 < u; c0 += 32) {
          uint32_t x = 0u;
          if (c0 + lane < u) {
            const int c = ucol[c0 + lane];
            x = column_word(kb0, kb1, n, q, ulist[c0 + lane], c >> 5, c & 31, askers);
          }
          drawn += __popc(warp_transpose(x, lane));
        }
        ones[i] = drawn;
      }
    } else if (u > 0) {
      // A warp 32 words w0 .. w0 + 31; lane k the window at their bit k,
      // starting at the warp's first 32 words, kWarps * 32 words a step.
      CubePos pos = cube_pos(static_cast<long long>(lane) * nw2 + warp * 32, n);
      const CubePos stride = cube_step(n, 32 * kWarps);
      for (int w0 = warp * 32; w0 < nw2; w0 += 32 * kWarps, cube_advance(pos, stride, n)) {
        const int len = nw2 - w0 < 32 ? nw2 - w0 : 32;
        const uint32_t win = need_window(pos, n, len, s_resp, asker);
        if (!__any_sync(kFull, win)) continue;
        const uint32_t need = warp_transpose(win, lane);  // word w0 + lane's
        const uint32_t y =
            need ? coin_word(kb0, kb1, static_cast<uint32_t>(w0 + lane)) & need : 0u;
        count_window(pos, n, warp_transpose(y, lane),
                     [&](int i, int c) { atomicAdd(&ones[i], c); });
      }
    }
    __syncthreads();

    // Majorities, then the quorum and verdict accumulators.
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      int maj = -1, seen_lt = 0, seen_hlt = 0;
      bool alive_i = false, disobey = false;
      if (i < n) {
        alive_i = s_alive[i];
        const int kind = s_kind[i];
        if (i == leader) {
          maj = order;
        } else if (kind != 0 || all_ask) {  // kind 0 here: a dead asker
          const bool odd = i & 1;
          int att = sc[H_ATT] + (odd ? sc[KO_ATT] : sc[KE_ATT]) + ones[i];
          int ret = sc[H_RET] + (odd ? sc[KO_RET] : sc[KE_RET]) +
                    (u - (kind == 3) - ones[i]);
          if (kind >= 2) {  // a faulty asker hears its own true value
            if (kind == 2) {
              const int v = lie_value(s_strat[i], i);
              att -= v == ATTACK;
              ret -= v == RETREAT;
            }
            att += s_recv[i] == ATTACK;
            ret += s_recv[i] == RETREAT;
          }
          maj = att > ret ? ATTACK : (ret > att ? RETREAT : UNDEFINED);
          if (kind != 0) seen_lt = 1 << maj;
          if (kind == 1) {
            seen_hlt = 1 << maj;
            disobey = maj != order;
          }
        }
        if (all_ask) p.majorities[row + i] = static_cast<signed char>(maj);
      }
      count(&sc[C_ATT], alive_i && maj == ATTACK, lane);
      count(&sc[C_RET], alive_i && maj == RETREAT, lane);
      count(&sc[C_UND], alive_i && maj == UNDEFINED, lane);
      count(&sc[DISOBEY], disobey, lane);
      bit_or(&sc[SEEN_LT], seen_lt, lane);
      bit_or(&sc[SEEN_HLT], seen_hlt, lane);
    }
    __syncthreads();

    if (tid == 0) {
      const int c_att = sc[C_ATT], c_ret = sc[C_RET];
      const int total = c_att + c_ret + sc[C_UND];
      int needed = 2 * ((total - 1) / 3) + 1;
      if (total <= 3) needed = total - 1;
      if (total == 1) needed = 1;
      int dec = needed <= c_ret ? RETREAT : (needed <= c_att ? ATTACK : UNDEFINED);
      if (total == 0) dec = UNDEFINED;
      const size_t out = static_cast<size_t>(r) * p.B + b;
      if (p.decisions) p.decisions[out] = static_cast<signed char>(dec);
      if (p.leaders) p.leaders[out] = leader;
      const int equivocation = __popc(sc[SEEN_LT]) > 1 && sc[TRAITOR] > 0;
      const int ic1 = __popc(sc[SEEN_HLT]) > 1;
      const int ic2 = !lf && sc[DISOBEY] > 0;
      if (p.slot) {  // one instance: always unanimous
        const int delta[5] = {dec == UNDEFINED, 1, equivocation, ic1, ic2};
        for (int c = 0; c < p.C; ++c) {
          cum[c] += delta[c];
          p.rows[out * p.C + c] = cum[c];
        }
      } else {
        atomicAdd(&p.hist[3 * r + dec], 1);
        if (equivocation) atomicAdd(&p.verdicts[3 * r + 0], 1);
        if (ic1) atomicAdd(&p.verdicts[3 * r + 1], 1);
        if (ic2) atomicAdd(&p.verdicts[3 * r + 2], 1);
      }
      for (int s = 0; s < N_SCALARS; ++s) sc[s] = 0;
      s_min = ~0ull;
      if (r + 1 < p.R) round_keys(r + 1);
    }
    __syncthreads();  // the next round counts into the zeroed scalars
  }

  if (scenario) {
    for (int j = tid; j < n; j += kThreads) {
      p.alive[row + j] = s_alive[j];
      p.faulty[row + j] = s_faulty[j];
      if (p.strategy) p.strategy[row + j] = s_strat[j];
    }
    if (tid == 0) p.leader[b] = leader;
  }
}

// Cumulative counter rows: quorum failures, unanimity (one bin holds the
// whole batch), equivocation[, ic1, ic2] added to the incoming block.
__global__ void counter_rows_kernel(int R, int B, int C, const int* hist,
                                    const int* verdicts,
                                    const int* counters_in, int* rows) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int cum[5];
  for (int c = 0; c < C; ++c) cum[c] = counters_in[c];
  for (int r = 0; r < R; ++r) {
    const int* h = hist + 3 * r;
    const int top = max(h[0], max(h[1], h[2]));
    const int delta[5] = {h[UNDEFINED], top == B, verdicts[3 * r],
                          verdicts[3 * r + 1], verdicts[3 * r + 2]};
    for (int c = 0; c < C; ++c) {
      cum[c] += delta[c];
      rows[r * C + c] = cum[c];
    }
  }
}

}  // namespace

#if defined(BA_COUNT_DRAWS)
// The threefry words counted since the last call, then cleared (the
// counting build only; waits for the card).
extern "C" unsigned long long ba_megastep_words_drawn() {
  unsigned long long v = 0, zero = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&v, ba_words_drawn, sizeof v);
  cudaMemcpyToSymbol(ba_words_drawn, &zero, sizeof zero);
  return v;
}
#endif

extern "C" size_t ba_megastep_smem_bytes(int n) {
  return static_cast<size_t>(n) * (3 * sizeof(int) + 5);
}

// Launch one dispatch on `stream`.  Plain mode passes null strategy and
// event planes; n_counters is 0 (no counter rows), 3 or 5.  Slot mode
// (slot != 0) takes [B, 2] keys, [B, n_counters] counters_in and writes
// [R, B, n_counters] counter_rows and [B, n] majorities; it passes null
// hist and verdicts and launches nothing else.  Returns
// cudaGetLastError() after the launches.
extern "C" int ba_megastep(
    int B, int n, int R, int n_counters, int slot, const void* key_data,
    const void* counter, const void* order, void* leader, void* faulty,
    void* alive, const void* ids, void* strategy, const void* kill,
    const void* revive, const void* set_faulty, const void* set_strategy,
    void* decisions, void* leaders, void* hist, void* verdicts,
    const void* counters_in, void* counter_rows, void* majorities, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.B = B;
  p.n = n;
  p.R = R;
  p.C = n_counters;
  p.slot = slot != 0;
  p.key_data = static_cast<const long long*>(key_data);
  p.counter = static_cast<const int*>(counter);
  p.order = static_cast<const signed char*>(order);
  p.leader = static_cast<int*>(leader);
  p.faulty = static_cast<unsigned char*>(faulty);
  p.alive = static_cast<unsigned char*>(alive);
  p.ids = static_cast<const int*>(ids);
  p.strategy = static_cast<signed char*>(strategy);
  p.kill = static_cast<const unsigned char*>(kill);
  p.revive = static_cast<const unsigned char*>(revive);
  p.set_faulty = static_cast<const signed char*>(set_faulty);
  p.set_strategy = static_cast<const signed char*>(set_strategy);
  p.decisions = static_cast<signed char*>(decisions);
  p.leaders = static_cast<int*>(leaders);
  p.hist = static_cast<int*>(hist);
  p.verdicts = static_cast<int*>(verdicts);
  p.counters_in = static_cast<const int*>(counters_in);
  p.rows = static_cast<int*>(counter_rows);
  p.majorities = static_cast<signed char*>(majorities);

  const size_t smem = ba_megastep_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.slot && (n_counters == 0 || !counters_in || !counter_rows || !majorities))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!p.slot) {
    cudaMemsetAsync(hist, 0, sizeof(int) * 3 * R, s);
    cudaMemsetAsync(verdicts, 0, sizeof(int) * 3 * R, s);
  }
  megastep_kernel<<<B, kThreads, smem, s>>>(p);
  if (n_counters > 0 && !p.slot) {
    counter_rows_kernel<<<1, 32, 0, s>>>(
        R, B, n_counters, p.hist, p.verdicts,
        static_cast<const int*>(counters_in), static_cast<int*>(counter_rows));
  }
  return static_cast<int>(cudaGetLastError());
}
