// Banded maximum-likelihood read<->haplotype-window alignment for Hopper.
//
// Replaces the reference package's TPU kernel
// locityper_tpu/ops/align_pallas.py:_kernel (reached through
// align_batch_pallas).  It computes the same function as the plain PyTorch
// version ops/align.py:align_batch_reference and is held bit-for-bit
// against it on the card (compile with --fmad=false: every j*del, i*clip
// and (len-i)*clip is a multiply followed by a separately rounded add).
//
// Bound: operations, not bytes.  A job reads L + (L+band) + 4 bytes and
// writes 28, but does about L*band cell updates, and the read rows form a
// sequential dependency chain.  One cell update is 52 float32/int32
// operations (adds, compares and selects of the recurrence below; shuffles,
// shared-memory traffic and address arithmetic move data and are not
// counted):
//    5  substitution score: r==h compare and select, h<4 and r<4, select
//    3  diagonal move: add; mismatch compare and add
//    3  insertion move: band-edge compare, add, select
//    8  ins > diag: compare, select of the score and 5 payloads, n_ins + 1
//    8  clip > base: compare, select of the score and 5 payloads, i + j
//    1  adj = base - j*del
//   15  deletion scan: 5 doubling steps x (compare, select of score and
//       origin)
//    5  origin restore: o==j compare, add, select; n_del + (j - o)
//    4  best end of the row: two band-edge selects, add of (len-i)*clip, max
//
// Design: one warp per job, or half a warp where the band fits 16 lanes x 3
// cells (bands 33..48, the short-read default: two jobs a warp and no padded
// cell).  The band's cells are striped over the job's lanes (cell j lives in
// lane j % LANES, register j / LANES: band 48 -> 3 cells in each of 16
// lanes, band 160 -> 5 cells in each of 32), so that
//   * the insertion move (cell j+1 of the previous row) is one shuffle from
//     the next lane,
//   * the deletion move is a max-plus scan along j in log2(max_del_run)
//     doubling steps, each a shuffle of (adjusted score, origin cell) - or
//     no shuffle at all where the step is a whole number of registers (16
//     cells on 16 lanes); the five op-count payloads are not carried through
//     the scan but gathered once from the winning origin through shared
//     memory,
//   * the best end is not searched row by row: each lane keeps the best
//     (score, row, cell, payloads) of its own cells with strict '>', which
//     keeps the earlier row and within a row the smaller cell, and one
//     reduction after the last row takes the largest score, then the
//     smallest row, then the smallest cell - the first row to reach the
//     maximum and the smallest j in it, as the row-by-row rule has it.
// A row's read code and window bases are single-byte loads that hit L1 on 31
// rows of 32; they are started at the top of the row, so that they are in
// flight while the previous row is shuffled (loading them a whole row ahead
// into registers was tried and cost 4 to 5 %).  Two warps a block: spreading
// few long jobs over more SMs gains 2 % there and costs nothing on short
// rows.
// In nearly every row some cell right of the read's diagonal takes a
// deletion from it (a deletion beats a mismatch there), so a fast path for
// rows without deletion origins would run in about one row of a hundred
// and is left out.
// The DP state is O(band) registers, so any read length runs (no row cap,
// no streamed variant), and jobs need not come in multiples of anything.
// Payloads are separate 32-bit counters: they do not wrap at 65,536.
// Rows past a read's length are skipped: with ln-probability scores
// (all <= 0) such a row can never beat the best end already found.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 2;             // warps per block
constexpr unsigned FULL = 0xffffffffu;

template <int LANES, int CPL>
__global__ void __launch_bounds__(32 * WARPS)
align_banded_kernel(const int8_t* __restrict__ reads,
                    const int32_t* __restrict__ lens,
                    const int8_t* __restrict__ wins,
                    const float* __restrict__ scores,
                    float* __restrict__ out_score,
                    int32_t* __restrict__ out_int,   // [6, N]
                    long long N, int L, int band, int max_del_run) {
  constexpr int S = CPL * LANES;                     // padded band
  constexpr int JOBS = 32 / LANES;                   // jobs a warp
  __shared__ int32_t pay_smem[WARPS * JOBS][5][S];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sl = lane % LANES;                       // lane within the job
  const long long first = ((long long)blockIdx.x * WARPS + warp) * JOBS;
  if (first >= N) return;                            // warps are independent
  // A half warp without a job walks the last job's rows and writes nothing.
  const bool has_job = first + lane / LANES < N;
  const long long job = has_job ? first + lane / LANES : N - 1;
  int32_t (*pay_s)[S] = pay_smem[warp * JOBS + lane / LANES];

  const float m_sc = scores[0], x_sc = scores[1], i_sc = scores[2],
              d_sc = scores[3], c_sc = scores[4];
  const int len = lens[job];
  const float len_f = (float)len;
  const int n_rows = has_job ? (len < L ? len : L) : 0;
  // Both jobs of a warp walk the rows of the longer one.
  int n_walk = n_rows;
  if (JOBS > 1) {
    const int other = __shfl_xor_sync(FULL, n_rows, LANES & 31);
    n_walk = other > n_walk ? other : n_walk;
  }
  const int8_t* rd = reads + job * (long long)L;
  const int8_t* wn = wins + job * (long long)(L + band);

  float prev[CPL], jd[CPL];
  int mism[CPL], ins[CPL], del[CPL], clip[CPL], sp[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = c * LANES + sl;
    prev[c] = j < band ? 0.0f : NEG;
    jd[c] = (float)j * d_sc;
    mism[c] = ins[c] = del[c] = clip[c] = 0;
    sp[c] = j;
  }
  // This lane's best end over its own cells.
  float best_s = NEG;
  int best_row = 0, best_j = sl, best_mism = 0, best_ins = 0, best_del = 0,
      best_clip = 0, best_sp = 0;
  const int nxt = (sl + 1) % LANES;

  for (int i = 1; i <= n_walk; ++i) {
    // The row's read code and window bases first: the loads are in flight
    // while the previous row is shuffled.
    const int r_c = rd[i - 1];
    int h_row[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = c * LANES + sl;
      h_row[c] = j < band ? (int)wn[i - 1 + j] : 4;
    }
    const float clip_s = c_sc * (float)i;

    // Previous row seen from cell j+1 (insertion source).
    float v_prev[CPL];
    int v_mism[CPL], v_ins[CPL], v_del[CPL], v_clip[CPL], v_sp[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      v_prev[c] = __shfl_sync(FULL, prev[c], nxt, LANES);
      v_mism[c] = __shfl_sync(FULL, mism[c], nxt, LANES);
      v_ins[c] = __shfl_sync(FULL, ins[c], nxt, LANES);
      v_del[c] = __shfl_sync(FULL, del[c], nxt, LANES);
      v_clip[c] = __shfl_sync(FULL, clip[c], nxt, LANES);
      v_sp[c] = __shfl_sync(FULL, sp[c], nxt, LANES);
    }

    float base[CPL], adj[CPL];
    int orig[CPL];
    __syncwarp();                     // last row's gathers are done
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = c * LANES + sl;
      const int h_c = h_row[c];
      float sub = (r_c == h_c) ? m_sc : x_sc;
      if (!(h_c < 4 && r_c < 4)) sub = NEG;
      const float diag_s = prev[c] + sub;
      int b_mism = mism[c] + (r_c != h_c ? 1 : 0);
      int b_ins = ins[c], b_del = del[c], b_clip = clip[c], b_sp = sp[c];

      // Cell j+1: next lane, or the job's first lane in the next register
      // for its last lane.
      float n_prev;
      int n_mism, n_ins, n_del, n_clip, n_sp;
      if (sl < LANES - 1 || c + 1 >= CPL) {
        n_prev = v_prev[c]; n_mism = v_mism[c]; n_ins = v_ins[c];
        n_del = v_del[c]; n_clip = v_clip[c]; n_sp = v_sp[c];
      } else {
        const int c1 = c + 1 < CPL ? c + 1 : c;
        n_prev = v_prev[c1]; n_mism = v_mism[c1]; n_ins = v_ins[c1];
        n_del = v_del[c1]; n_clip = v_clip[c1]; n_sp = v_sp[c1];
      }
      const float ins_s = (j >= band - 1) ? NEG : n_prev + i_sc;
      if (ins_s > diag_s) {
        base[c] = ins_s;
        b_mism = n_mism; b_ins = n_ins + 1; b_del = n_del; b_clip = n_clip;
        b_sp = n_sp;
      } else {
        base[c] = diag_s;
      }
      if (clip_s > base[c]) {
        base[c] = clip_s;
        b_mism = 0; b_ins = 0; b_del = 0; b_clip = i; b_sp = i + j;
      }
      adj[c] = base[c] - jd[c];
      orig[c] = j;
      pay_s[0][j] = b_mism; pay_s[1][j] = b_ins; pay_s[2][j] = b_del;
      pay_s[3][j] = b_clip; pay_s[4][j] = b_sp;
    }

    // Deletion max-plus scan along j: doubling, strictly greater wins.
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = 1 << k;
      if (s < max_del_run) {
        const int q = s / LANES, r = s % LANES;
        const int src = (sl - r + LANES) % LANES;
        const bool borrow = sl < r;
        float va[CPL];
        int vo[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (r != 0) {
            va[c] = __shfl_sync(FULL, adj[c], src, LANES);
            vo[c] = __shfl_sync(FULL, orig[c], src, LANES);
          } else {                     // a whole number of registers
            va[c] = adj[c];
            vo[c] = orig[c];
          }
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int c0 = c - q;          // register of cell j-s, no borrow
          float sh = NEG;
          int so = 0;
          if (c0 >= 0) {
            sh = va[c0 >= 0 ? c0 : 0];
            so = vo[c0 >= 0 ? c0 : 0];
          }
          if (borrow) {
            if (c0 - 1 >= 0) {
              sh = va[c0 - 1 >= 0 ? c0 - 1 : 0];
              so = vo[c0 - 1 >= 0 ? c0 - 1 : 0];
            } else {
              sh = NEG;
              so = 0;
            }
          }
          if (sh > adj[c]) {
            adj[c] = sh;
            orig[c] = so;
          }
        }
      }
    }

    // Payloads follow the winning origin; the lane's best end so far.
    __syncwarp();
    const float end_bonus = (len_f - (float)i) * c_sc;
    const bool live = i <= n_rows;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = c * LANES + sl;
      const int o = orig[c];
      const float row_s = (o == j) ? base[c] : adj[c] + jd[c];
      mism[c] = pay_s[0][o];
      ins[c] = pay_s[1][o];
      del[c] = pay_s[2][o] + (j - o);
      clip[c] = pay_s[3][o];
      sp[c] = pay_s[4][o];
      prev[c] = j < band ? row_s : NEG;
      const float cand = j < band ? row_s + end_bonus : -INFINITY;
      if (live && cand > best_s) {
        best_s = cand;
        best_row = i;
        best_j = j;
        best_mism = mism[c]; best_ins = ins[c]; best_del = del[c];
        best_clip = clip[c] + (len - i);
        best_sp = sp[c];
      }
    }
  }

  // The job's best end: largest score, then smallest row, then smallest j.
  float top_s = best_s;
  int top_row = best_row, top_j = best_j;
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    const float o_s = __shfl_xor_sync(FULL, top_s, off, LANES);
    const int o_row = __shfl_xor_sync(FULL, top_row, off, LANES);
    const int o_j = __shfl_xor_sync(FULL, top_j, off, LANES);
    if (o_s > top_s ||
        (o_s == top_s &&
         (o_row < top_row || (o_row == top_row && o_j < top_j)))) {
      top_s = o_s;
      top_row = o_row;
      top_j = o_j;
    }
  }
  if (has_job && sl == top_j % LANES) {   // the lane that holds the winner
    out_score[job] = best_s;
    out_int[0 * N + job] = best_mism;
    out_int[1 * N + job] = best_ins;
    out_int[2 * N + job] = best_del;
    out_int[3 * N + job] = best_clip;
    out_int[4 * N + job] = best_sp;
    out_int[5 * N + job] = top_row + top_j;
  }
}

template <int LANES, int CPL>
cudaError_t launch(const int8_t* reads, const int32_t* lens,
                   const int8_t* wins, const float* scores, float* out_score,
                   int32_t* out_int, long long N, int L, int band,
                   int max_del_run, cudaStream_t stream) {
  constexpr int per_block = WARPS * (32 / LANES);
  const long long blocks = (N + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  align_banded_kernel<LANES, CPL><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
      reads, lens, wins, scores, out_score, out_int, N, L, band, max_del_run);
  return cudaGetLastError();
}

}  // namespace

// reads [N, L] int8, lens [N] int32, wins [N, L+band] int8, scores [5] f32
// -> out_score [N] f32, out_int [6, N] int32 (n_mism, n_ins, n_del, n_clip,
// start_p, end_p).  1 <= band <= 256.  Returns the cudaError_t of the launch.
extern "C" int align_banded_launch(const void* reads, const void* lens,
                                   const void* wins, const void* scores,
                                   void* out_score, void* out_int,
                                   long long N, int L, int band,
                                   int max_del_run, void* stream) {
  if (N <= 0) return 0;
  if (band < 1 || band > 256 || L < 0) return (int)cudaErrorInvalidValue;
  auto* r = (const int8_t*)reads;
  auto* l = (const int32_t*)lens;
  auto* w = (const int8_t*)wins;
  auto* s = (const float*)scores;
  auto* os = (float*)out_score;
  auto* oi = (int32_t*)out_int;
  auto st = (cudaStream_t)stream;
  // Bands 33..48: 16 lanes x 3 cells, two jobs a warp.
  if (band > 32 && band <= 48)
    return (int)launch<16, 3>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
  const int cpl = (band + 31) / 32;
  switch (cpl) {
    case 1: return (int)launch<32, 1>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 2: return (int)launch<32, 2>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 3: return (int)launch<32, 3>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 4: return (int)launch<32, 4>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 5: return (int)launch<32, 5>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 6: return (int)launch<32, 6>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    case 7: return (int)launch<32, 7>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
    default: return (int)launch<32, 8>(r, l, w, s, os, oi, N, L, band, max_del_run, st);
  }
}
