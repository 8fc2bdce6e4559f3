// Minimizer front end of read recruitment for Hopper: canonical 2-bit
// k-mers -> murmur mix -> signed view -> window-minimizer mask, and either
// all positions written out (full-width entry) or the first S minimizers of
// each read packed to the front in position order (compacting entry).
//
// Replaces two TPU kernels of the reference package, which share one body
// (locityper_tpu/ops/recruit.py:_hash_mask_body):
//   _front_compact_pallas  -> minimizer_front_compact_launch
//   _hash_mask_pallas      -> minimizer_front_full_launch
// It computes the same function as the plain PyTorch version
// ops/recruit.py:minimizer_front_reference and is held bit-for-bit against it
// on the card on every output (integers only, so there is no tolerance).
//
// Per read row of L codes (0-3 bases, anything else invalid), k <= 15,
// P = L - k + 1 positions:
//   fw / rv   2-bit k-mers of codes p..p+k-1 and of their reverse complement
//   is_fw     fw <= rv; kmer = min(fw, rv)
//   x         ~kmer; x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13   (uint32)
//   hs        int32(x ^ 0x80000000): the order-preserving signed view;
//             0x7FFFFFFF (BIG) where any of the k codes is invalid
//   mask      a' + b' >= w - 1 and hs != BIG, with a' the run of left
//             neighbours whose hs is strictly greater and b' the run of right
//             neighbours whose hs is greater or equal, each capped at w - 1
//             and at the row's edges: the position is the first argmin of
//             some window of w positions
// Full-width entry: hs, is_fw, mask as [B, P].  Compacting entry: the
// position of inclusive rank r <= S among the row's mask bits writes
// (hs, is_fw, 1) to column r - 1, the columns past the row's count get
// (BIG, 0, 0), and total is the row's whole count, not capped at S.
//
// Bound: bytes.  A position reads one byte of codes; the full-width entry
// writes 6 bytes for it, the compacting entry 6 * S / P.  Operations of one
// position, counted once for the rolling form of the k-mers (what the
// function needs; this kernel rebuilds each k-mer from its k codes, which is
// more), 26 + 4 * (w - 1) int32 operations, 62 at w = 10:
//    2  code validity: compare with 4, select 0
//    3  forward k-mer: shift, or, and
//    4  reverse k-mer: 3 - c, shift, shift, or
//    2  run of valid codes: add or reset, compare with k
//    2  canonical k-mer: compare, select
//    7  mix and signed view: not, shift, xor, multiply, shift, xor, xor
//    1  BIG where invalid
//    4 * (w - 1)  window rule, every neighbour examined: compare and add,
//       w - 1 to the left and w - 1 to the right (a run that ends early
//       examines fewer)
//    5  a' + b', compare with w - 1, hs != BIG, and; rank add
// At 3.35e12 B/s and 67e12 op/s bytes bound both entries.
//
// Design: one thread block per read row, one thread per position of a tile
// of 256 positions.  A tile stages its codes in shared memory with a halo of
// w - 1 positions on both sides and k - 1 codes on the right, then the
// hashes of the tile and its halo, so that every neighbour the window rule
// looks at is a shared-memory read.  The compacting entry ranks the mask by
// warp ballot + popcount with a per-warp offset, and carries the row's count
// from tile to tile, so L has no cap and B need not be a multiple of
// anything.  The full-width rolls, the log-tree prefix and the S-step masked
// column reduce of the TPU kernel are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;             // positions per tile
constexpr int WARPS = THREADS / 32;
constexpr int32_t BIG = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 48 * 1024;      // static + dynamic, no opt-in

template <bool COMPACT>
__global__ void __launch_bounds__(THREADS)
minimizer_front_kernel(const int8_t* __restrict__ reads, int L, int k, int w,
                       int S, int32_t* __restrict__ out_h,
                       uint8_t* __restrict__ out_fw,
                       uint8_t* __restrict__ out_mask,
                       int32_t* __restrict__ out_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_count[WARPS];
  const int halo = w - 1;
  const int n_hs = THREADS + 2 * halo;    // hashes staged per tile
  const int n_codes = n_hs + k - 1;       // codes staged per tile
  int32_t* hs_s = reinterpret_cast<int32_t*>(smem_raw);          // [n_hs]
  uint8_t* fw_s = reinterpret_cast<uint8_t*>(hs_s + n_hs);       // [n_hs]
  int8_t* code_s = reinterpret_cast<int8_t*>(fw_s + n_hs);       // [n_codes]

  const long long row = blockIdx.x;
  const int P = L - k + 1;
  const int8_t* rd = reads + row * (long long)L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long out_row = row * (long long)(COMPACT ? S : P);
  int base = 0;          // minimizers of the row before this tile (uniform)

  for (int p0 = 0; p0 < P; p0 += THREADS) {
    const int q0 = p0 - halo;             // first staged position
    for (int i = tid; i < n_codes; i += THREADS) {
      const int c = q0 + i;
      code_s[i] = (c >= 0 && c < L) ? rd[c] : (int8_t)4;
    }
    __syncthreads();
    for (int i = tid; i < n_hs; i += THREADS) {
      const int q = q0 + i;
      int32_t hs = BIG;
      uint8_t is_fw = 0;
      if (q >= 0 && q < P) {
        uint32_t fw = 0, rv = 0;
        bool ok = true;
        for (int j = 0; j < k; ++j) {
          uint32_t c = (uint8_t)code_s[i + j];
          if (c >= 4u) { ok = false; c = 0u; }
          fw |= c << (2 * (k - 1 - j));
          rv |= (3u - c) << (2 * j);
        }
        is_fw = fw <= rv;
        uint32_t x = ~(is_fw ? fw : rv);
        x ^= x >> 16;
        x *= 0x85EBCA6Bu;
        x ^= x >> 13;
        if (ok) hs = (int32_t)(x ^ 0x80000000u);
      }
      hs_s[i] = hs;
      fw_s[i] = is_fw;
    }
    __syncthreads();

    const int p = p0 + tid;
    const int c = tid + halo;             // this position in hs_s
    int32_t h = BIG;
    bool m = false;
    if (p < P) {
      h = hs_s[c];
      if (h != BIG) {
        const int amax = min(halo, p), bmax = min(halo, P - 1 - p);
        int a = 0, b = 0;
        while (a < amax && hs_s[c - a - 1] > h) ++a;
        while (b < bmax && hs_s[c + b + 1] >= h) ++b;
        m = a + b >= halo;
      }
    }

    if (!COMPACT) {
      if (p < P) {
        out_h[out_row + p] = h;
        out_fw[out_row + p] = fw_s[c];
        out_mask[out_row + p] = m ? 1 : 0;
      }
    } else {
      const unsigned bal = __ballot_sync(FULL, m);
      if (lane == 0) warp_count[warp] = __popc(bal);
      __syncthreads();
      int before = base, tile_count = 0;
      for (int v = 0; v < WARPS; ++v) {
        if (v < warp) before += warp_count[v];
        tile_count += warp_count[v];
      }
      if (m) {
        const int r = before + __popc(bal & ((1u << lane) - 1u));  // 0-based
        if (r < S) {
          out_h[out_row + r] = h;
          out_fw[out_row + r] = fw_s[c];
          out_mask[out_row + r] = 1;
        }
      }
      base += tile_count;
    }
    __syncthreads();      // the next tile overwrites the staged arrays
  }

  if (COMPACT) {
    for (int s = min(base, S) + tid; s < S; s += THREADS) {
      out_h[out_row + s] = BIG;
      out_fw[out_row + s] = 0;
      out_mask[out_row + s] = 0;
    }
    if (tid == 0) out_total[row] = base;
  }
}

template <bool COMPACT>
int launch(const void* reads, long long B, int L, int k, int w, int S,
           void* out_h, void* out_fw, void* out_mask, void* out_total,
           void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int n_hs = THREADS + 2 * (w - 1);
  const size_t smem = (size_t)n_hs * 5 + (size_t)(n_hs + k - 1);
  if (k < 1 || k > 15 || w < 1 || L < k || B > 0x7fffffffLL ||
      (COMPACT && S < 1) || smem + sizeof(int) * WARPS > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  minimizer_front_kernel<COMPACT>
      <<<(unsigned)B, THREADS, smem, (cudaStream_t)stream>>>(
          (const int8_t*)reads, L, k, w, S, (int32_t*)out_h,
          (uint8_t*)out_fw, (uint8_t*)out_mask, (int32_t*)out_total);
  return (int)cudaGetLastError();
}

}  // namespace

// reads [B, L] int8; hs [B, P] int32; is_fw, mask [B, P] bytes of 0 / 1.
extern "C" int minimizer_front_full_launch(const void* reads, void* hs,
                                           void* is_fw, void* mask,
                                           long long B, int L, int k, int w,
                                           void* stream) {
  return launch<false>(reads, B, L, k, w, 0, hs, is_fw, mask, nullptr,
                       stream);
}

// reads [B, L] int8; hs [B, S] int32; is_fw, mask [B, S] bytes; total [B].
extern "C" int minimizer_front_compact_launch(const void* reads, void* hs,
                                              void* is_fw, void* mask,
                                              void* total, long long B, int L,
                                              int k, int w, int S,
                                              void* stream) {
  return launch<true>(reads, B, L, k, w, S, hs, is_fw, mask, total, stream);
}
