// Read-assignment annealer for Hopper: C = G x attempts independent chains.
//
// Replaces the reference package's TPU kernel
// locityper_tpu/ops/solver_pallas.py:_kernel (reached through
// solve_genotypes_pallas).  It computes the same function, step for step, as
// the plain PyTorch version ops/solver_chains.py:anneal_chains_reference and
// consumes the same Philox4x32-10 stream, so that with no annealing steps
// (no expf) both give identical assignments and likelihoods on the card
// (compile with --fmad=false).
//
// Bound: each input read once and each output written once, or the moves'
// arithmetic, whichever is longer; what really limits a launch is neither:
// every move is a chain of ~5 dependent loads (read -> slot -> window pair
// -> depth -> table), and a chain's moves depend on one another through
// its state, so the run takes memory latency times the rounds of its
// slowest chain.  Moves evaluated again after a conflict are this design's
// cost and are not part of the function's work.
// One proposed move is 232 float32/int32 operations (address arithmetic
// and loads not counted):
//  100  Philox4x32-10: 10 rounds x (2 mul.hi, 2 mul.lo, 4 xor, 2 key adds)
//   23  three uniforms (shift, convert, multiply), two bounded integers
//       (multiply, convert, min, convert), vc-1, max, 1+, and the slot
//       skipping the current one (compare, subtract, select)
//    6  unpacking two window pairs (2 and, 2 shift, 2 and)
//   28  shared-window cascade: 6 compares, 22 and/or/select/add
//   36  4 windows x (add, two clamps of a compare and a select each, table
//       index, subtract, compare, select)
//    7  delta: 2 multiplies, 1 subtract, 4 adds
//    5  temperature: subtract, max, convert, multiply, divide
//   13  acceptance: subtract, max, divide, expf, 5 compares, and/or, select,
//       stale counter
//   14  accepted move: the branch, 4 depth adds, 4 compares and 4 selects
//       of the cache, the new slot; counted for every proposed move
//
// Design: one warp per chain, 32 steps at a time.  A chain changes little
// state (assgn[R], depth[W], cache[W]: 3 KB at R 512, W 130) and only reads
// the large tables, and the generator is counter-based, so a step's random
// picks need no earlier step.  For a batch of 32 steps, lane l
//   1. runs Philox for step s0 + l, picks the read (loaded one batch
//      ahead), the slot index, the acceptance draw and the temperature:
//      none of it depends on the state;
//   2. evaluates its move against the state at the start of the batch, so
//      that the 32 chains of dependent loads (slot -> probabilities and
//      window pairs -> depths -> table entries) overlap;
//   3. the batch is then settled in order, a stretch of lanes at a time.
//      Lane y disturbs lane x if both picked the same read or if both moves
//      change the depth of one window (the cascade names those windows: a
//      window whose depth a move leaves as it is, is neither needed nor
//      changed).  With the state in shared memory every window carries a
//      mask of the lanes that change it, so a lane reads its rivals with
//      four loads.  The first lane that an accepted earlier lane of the
//      stretch disturbs ends the stretch; the lanes before it stand as
//      computed, and the accepted ones among them disturb one another no
//      more than they disturb that lane, so they write different words and
//      apply their moves together.  The later lanes that these moves
//      disturb evaluate again, against the state as it then is - from the
//      slot on if it was their read's, else the depth terms only - and the
//      next stretch begins at the lane that ended this one.
// The sequence of states is the sequential one, so assignments, likelihoods
// and step counts equal the plain version's to the bit.  The plateau is
// found in the same masks: `stale` grows by one a rejection and returns to 0
// at an accepted move, so the step at which it reaches `plato` is a lane
// number.  While a chain is hot nearly every move is accepted and a stretch
// is a lane or two; once it polishes, a batch settles in little more than
// one round.  The state lies in shared memory
// (a few chains a block); where one chain's state does not fit, the same
// kernel (template parameter) keeps it in global memory and the lanes
// compare their windows by shuffle.  The final likelihood is summed by all
// lanes in the sequential order of the plain loop (values passed by
// shuffle), so its rounding is the earlier design's.  The TPU kernel's
// masked-reduce "gathers", its boolean-algebra select and its block-wide
// exit every 128 steps were Mosaic's needs and are not carried over: a
// frozen chain simply stops.  Candidate probabilities depend on the
// genotype only and are shared by its attempts.
// Tried on the card and left out: entries of a window's table row at the
// neighbouring depths kept in registers (more loads, 50 % slower); windows
// whose table row is constant taken out of the rivalry (5 %); evaluating
// only the next 4 to 16 pending lanes (no gain).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // chains (warps) per block, at most
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;     // bytes a block can use on sm_90

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// Uniform [0,1) from the top 24 bits.
__device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ int randint(float u, int bound) {
  const int v = (int)(u * (float)bound);
  return v < bound - 1 ? v : bound - 1;
}

// Lanes [pos, 32).
__device__ __forceinline__ unsigned lanes_from(int pos) {
  return pos >= 32 ? 0u : FULL << pos;
}

// The lanes whose move, if applied, would change what this lane evaluated:
// those that picked the same read, and those whose move changes the depth
// of a window whose depth this lane's move changes too (`ew`; the relation
// is symmetric).  With the state in shared memory, `users` holds a mask of
// lanes for every window; else the lanes compare their windows by shuffle.
template <bool SMEM>
__device__ __forceinline__ unsigned rivals_of(const int (&ew)[4],
                                              unsigned same_read,
                                              const unsigned* users) {
  unsigned rivals = same_read;
  if constexpr (SMEM) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ew[q] >= 0) rivals |= users[ew[q]];
  } else {
    for (int other = 0; other < 32; ++other) {
      bool shared_window = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int w = __shfl_sync(FULL, ew[q], other);
        shared_window = shared_window ||
                        (w >= 0 && (w == ew[0] || w == ew[1] ||
                                    w == ew[2] || w == ew[3]));
      }
      rivals |= shared_window ? 1u << other : 0u;
    }
  }
  return rivals;
}

template <bool SMEM>
__global__ void __launch_bounds__(32 * WARPS)
anneal_chains_kernel(const float* __restrict__ probs,      // [G, R, K]
                     const int32_t* __restrict__ winpk,    // [C, R, K]
                     const int32_t* __restrict__ vcount,   // [G, R]
                     const int32_t* __restrict__ nt_ixs,   // [G, R]
                     const int32_t* __restrict__ ntc,      // [G]
                     const float* __restrict__ start_temp, // [G]
                     const float* __restrict__ wtab,       // [C, W, D]
                     int32_t* assgn,                       // [C, R] in/out
                     int32_t* depth,                       // [C, W] in/out
                     float* cache,                         // [C, W] in/out
                     float* __restrict__ lik,              // [C]
                     int32_t* __restrict__ steps_done,     // [C]
                     int C, int R, int K, int W, int D, int attempts,
                     int n_steps, int anneal_steps, int plato, float dc,
                     float ac, float ln_init_prob, uint32_t k0, uint32_t k1,
                     unsigned long long* schedule) {           // [2] or null
  extern __shared__ int32_t state_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;                       // warps are independent
  const int g = c / attempts;
  const float* pr = probs + (long long)g * R * K;
  const int32_t* wp = winpk + (long long)c * R * K;
  const int32_t* vc_g = vcount + (long long)g * R;
  const int32_t* nt_g = nt_ixs + (long long)g * R;
  const float* wt = wtab + (long long)c * W * D;
  int32_t* as_g = assgn + (long long)c * R;
  int32_t* dp_g = depth + (long long)c * W;
  float* ch_g = cache + (long long)c * W;
  int32_t *as, *dp;
  float* ch;
  // users[w]: the lanes whose move, as last evaluated, changes the depth of
  // window w (shared-memory state only).
  unsigned* users = nullptr;
  if constexpr (SMEM) {
    as = state_smem + (long long)warp * (R + 3 * W);
    dp = as + R;
    ch = reinterpret_cast<float*>(dp + W);
    users = reinterpret_cast<unsigned*>(dp + 2 * W);
    for (int x = lane; x < R; x += 32) as[x] = as_g[x];
    for (int x = lane; x < W; x += 32) {
      dp[x] = dp_g[x];
      ch[x] = ch_g[x];
      users[x] = 0u;
    }
  } else {
    as = as_g;
    dp = dp_g;
    ch = ch_g;
  }
  __syncwarp();

  const int nt_count = ntc[g];
  const float st = start_temp[g];
  const float denom = (float)(anneal_steps > 1 ? anneal_steps : 1);
  const float min_diff =
      plato ? fmaxf(st * (-ln_init_prob) * 1e-6f, 1e-10f) : 0.0f;
  int stale = 0;            // warp-uniform, like everything the walk decides
  int s_end = n_steps;
  unsigned rounds = 0, batches = 0;
  bool frozen = false;

  // The read that lane l picks at step s0 + l is loaded one batch ahead.
  uint32_t rnd[4];
  philox4x32_10((uint32_t)c, (uint32_t)lane, 0u, 0u, k0, k1, rnd);
  int r_next = nt_g[randint(u01(rnd[0]), nt_count)];

  for (int s0 = 0; s0 < n_steps && !frozen; s0 += 32) {
    const int nvalid = n_steps - s0 < 32 ? n_steps - s0 : 32;
    // 1. What does not depend on the state: one lane a step.
    const int s = s0 + lane;
    const int r = r_next;
    const int vc = vc_g[r];
    const int i = 1 + randint(u01(rnd[1]), vc - 1 > 1 ? vc - 1 : 1);
    const float u = u01(rnd[2]);
    const int rem = anneal_steps - s;
    const float s_rem = (float)(rem > 0 ? rem : 0);
    const float temp = st * s_rem / denom;
    philox4x32_10((uint32_t)c, (uint32_t)(s + 32), 0u, 0u, k0, k1, rnd);
    r_next = nt_g[randint(u01(rnd[0]), nt_count)];

    // The lane's move as last evaluated: the slot and what follows from it
    // (a), then what follows from the depths of its windows (b).
    int nw = 0;
    float d_aln = 0.0f;
    int wv[4] = {0, 0, 0, 0}, cv[4] = {0, 0, 0, 0};
    int ew[4] = {-1, -1, -1, -1};   // the windows whose depth the move changes
    int nd[4] = {0, 0, 0, 0};
    float nv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool accept = false;

    // Lanes to evaluate: from the slot on (pend_a), or the depths only.
    const unsigned valid = lanes_from(0) & ~lanes_from(nvalid);
    const unsigned same_read = __match_any_sync(FULL, r);
    unsigned pend = valid, pend_a = valid;
    unsigned rivals = 0u;         // the lanes whose moves disturb this one's
    bool marks_moved = true;
    int pos = 0;                                          // next lane to settle
    for (;;) {
      // 2. Evaluate against the state as it is now.
      if ((pend_a >> lane) & 1u) {
        const int cur = as[r];
        nw = i <= cur ? i - 1 : i;
        const float p_cur = pr[(long long)r * K + cur];
        const float p_new = pr[(long long)r * K + nw];
        const int wp_cur = wp[(long long)r * K + cur];
        const int wp_new = wp[(long long)r * K + nw];
        d_aln = ac * (p_new - p_cur);
        const int w1 = wp_cur & 0xFFFF, w2 = (wp_cur >> 16) & 0xFFFF;
        const int w3 = wp_new & 0xFFFF, w4 = (wp_new >> 16) & 0xFFFF;

        // Shared-window cascade (assgn.rs:259-284): the net change of a
        // window's depth goes to its first occurrence.
        int c1 = -1, c2, c3, c4;
        const bool e21 = w2 == w1;
        c2 = e21 ? 0 : -1;
        c1 += e21 ? -1 : 0;
        const bool e31 = w3 == w1, e32 = w3 == w2;
        c3 = (e31 || e32) ? 0 : 1;
        c1 += e31 ? 1 : 0;
        c2 += (!e31 && e32) ? 1 : 0;
        const bool e41 = w4 == w1, e42 = w4 == w2, e43 = w4 == w3;
        c4 = (e41 || e42 || e43) ? 0 : 1;
        c1 += e41 ? 1 : 0;
        c2 += (!e41 && e42) ? 1 : 0;
        c3 += (!e41 && !e42 && e43) ? 1 : 0;
        wv[0] = w1; wv[1] = w2; wv[2] = w3; wv[3] = w4;
        cv[0] = c1; cv[1] = c2; cv[2] = c3; cv[3] = c4;
        // The lane's marks move with its windows: all old ones first.
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (SMEM && ew[q] >= 0) atomicAnd(&users[ew[q]], ~(1u << lane));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ew[q] = cv[q] != 0 ? wv[q] : -1;
          if (SMEM && ew[q] >= 0) atomicOr(&users[ew[q]], 1u << lane);
        }
      }
      if ((pend >> lane) & 1u) {
        float dd[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d0 = dp[wv[q]];
          const float cur_v = ch[wv[q]];
          nd[q] = d0 + cv[q];
          int d1 = nd[q];
          d1 = d1 < 0 ? 0 : (d1 > D - 1 ? D - 1 : d1);
          nv[q] = wt[(long long)wv[q] * D + d1];
          dd[q] = cv[q] == 0 ? 0.0f : nv[q] - cur_v;
        }
        const float delta =
            d_aln + dc * (((dd[0] + dd[1]) + dd[2]) + dd[3]);

        // Metropolis while the chain cools (temp > 0), then strict
        // improvement; expf only where it can decide.
        if (plato) {
          const float diffm = delta - min_diff;
          accept = s < anneal_steps ? diffm >= 0.0f : delta > min_diff;
          if (!accept && s < anneal_steps && temp > 0.0f)
            accept = u <= expf(diffm / fmaxf(temp, 1e-30f));
        } else {
          accept = delta >= 0.0f;
          if (!accept && temp > 0.0f)
            accept = u <= expf(delta / fmaxf(temp, 1e-30f));
        }
      }
      ++rounds;
      __syncwarp();                         // all reads of the state are done
      const unsigned acc = __ballot_sync(FULL, accept);

      // 3. Settle, at once, every lane up to the first one that an accepted
      // earlier lane of this stretch disturbs.  The accepted lanes before
      // it disturb one another no more than they disturb it, so no two of
      // them write the same word and they apply their moves together.
      if (marks_moved) rivals = rivals_of<SMEM>(ew, same_read, users);
      const unsigned open = valid & lanes_from(pos);
      const unsigned before_me = ~lanes_from(lane);
      const unsigned dirty =
          __ballot_sync(FULL, (rivals & acc & open & before_me) != 0u) & open;
      const int f = dirty ? __ffs(dirty) - 1 : nvalid;
      unsigned moved = acc & open & ~lanes_from(f);
      // Rejections add to `stale`, an accepted move sets it to 0, and the
      // chain freezes before the step at which it reaches `plato`.
      int run_from = pos;
      if (plato) {
        for (unsigned m = moved;;) {
          const int a = m ? __ffs(m) - 1 : f;
          const int stop = run_from + (plato - stale);
          if (stop <= a) {
            s_end = s0 + stop;
            frozen = true;
            moved &= ~lanes_from(stop);
            break;
          }
          if (!m) break;
          m &= m - 1u;
          run_from = a + 1;
          stale = 0;
          if (plato >= 32) {                // no later run can reach it here
            run_from = 32 - __clz(moved);
            break;
          }
        }
      }
      stale += f - run_from;
      pos = f;
      if ((moved >> lane) & 1u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (cv[q] != 0) {
            dp[wv[q]] = nd[q];
            ch[wv[q]] = nv[q];
          }
        }
        as[r] = nw;
      }
      // Later lanes that a move disturbed evaluate again: from the slot on
      // if it was their read's, else the depth terms only.
      const unsigned rest = valid & lanes_from(f);
      pend_a = __ballot_sync(FULL, (same_read & moved) != 0u) & rest;
      pend = __ballot_sync(FULL, (rivals & moved) != 0u) & rest;
      marks_moved = pend_a != 0u;
      __syncwarp();                         // the new state is visible
      if (frozen || pos >= nvalid) break;
    }
    if constexpr (SMEM) {                   // the batch's marks are retired
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ew[q] >= 0) atomicAnd(&users[ew[q]], ~(1u << lane));
    }
    ++batches;
  }
  __syncwarp();

  // Final likelihood from the end state: float64 sums in the order of the
  // sequential loop, rounded once.  Every lane adds the same values.
  double dep = 0.0, aln = 0.0;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const float v = w0 + lane < W ? ch[w0 + lane] : 0.0f;
    const int n = W - w0 < 32 ? W - w0 : 32;
    for (int l = 0; l < n; ++l) dep += (double)__shfl_sync(FULL, v, l);
  }
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int r = r0 + lane;
    const float v = r < R ? pr[(long long)r * K + as[r]] : 0.0f;
    const int n = R - r0 < 32 ? R - r0 : 32;
    for (int l = 0; l < n; ++l) aln += (double)__shfl_sync(FULL, v, l);
  }
  if constexpr (SMEM) {
    for (int x = lane; x < R; x += 32) as_g[x] = as[x];
    for (int x = lane; x < W; x += 32) {
      dp_g[x] = dp[x];
      ch_g[x] = ch[x];
    }
  }
  if (lane == 0) {
    lik[c] = dc * (float)dep + ac * (float)aln;
    steps_done[c] = s_end;
    if (schedule != nullptr) {
      atomicAdd(&schedule[0], (unsigned long long)rounds);
      atomicAdd(&schedule[1], (unsigned long long)batches);
    }
  }
}

}  // namespace

// See ops/solver_chains.py for the layouts.  assgn, depth and cache are
// updated in place; steps_done [C] receives the moves each chain proposed
// before it froze or ran out of steps.  `schedule` is null or two 64-bit
// words on the device to which every chain adds its evaluation rounds and
// its batches: 32 * batches / rounds is the mean length of a stretch, which
// says how much of the 32-fold overlap the data allowed.  Returns the
// cudaError_t of the launch.
extern "C" int anneal_chains_launch(
    const void* probs, const void* winpk, const void* vcount,
    const void* nt_ixs, const void* ntc, const void* start_temp,
    const void* wtab, void* assgn, void* depth, void* cache, void* lik,
    void* steps_done, int C, int R, int K, int W, int D, int attempts, int n_steps,
    int anneal_steps, int plato, float dc, float ac, float ln_init_prob,
    long long seed, void* schedule, void* stream) {
  if (C <= 0) return 0;
  if (attempts < 1 || R < 1 || K < 1 || W < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned long long useed = (unsigned long long)seed;
  // Chains a block: as many as fit shared memory, at most WARPS; a chain
  // whose state fits no block keeps it in global memory.
  const long long chain_bytes = 4LL * ((long long)R + 3LL * W);
  const long long fit = MAX_SMEM / chain_bytes;
  const bool in_smem = fit >= 1;
  const int wpb = in_smem && fit < WARPS ? (int)fit : WARPS;
  const size_t smem = in_smem ? (size_t)(wpb * chain_bytes) : 0;
  auto kernel = in_smem ? anneal_chains_kernel<true>
                        : anneal_chains_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + wpb - 1) / wpb;
  kernel<<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      (const float*)probs, (const int32_t*)winpk, (const int32_t*)vcount,
      (const int32_t*)nt_ixs, (const int32_t*)ntc, (const float*)start_temp,
      (const float*)wtab, (int32_t*)assgn, (int32_t*)depth, (float*)cache,
      (float*)lik, (int32_t*)steps_done, C, R, K, W, D, attempts, n_steps,
      anneal_steps, plato, dc, ac, ln_init_prob,
      (uint32_t)(useed & 0xFFFFFFFFull), (uint32_t)(useed >> 32),
      (unsigned long long*)schedule);
  return (int)cudaGetLastError();
}
