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
// Per read row of L codes (0-3 bases, anything else invalid), k <= 16
// (2k-bit k-mers, all 32 bits of a word at k = 16), P = L - k + 1
// positions:
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
// function needs), 26 + 4 * (w - 1) int32 operations, 62 at w = 10, for
// every k (k only moves P):
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
// At 3.35e12 B/s and 67e12 op/s bytes bound both entries.  What keeps the
// kernel from that bound is issue and latency: per position it does several
// times these operations (k - 1 codes to fill each lane's first k-mer, a
// halo of 2 (w - 1) hashes per chunk, log2 w passes of 64-bit minima) and
// every step waits on shared memory.
//
// Design: a warp is the unit of work, MAX_WARPS warps a block, and nothing
// but __syncwarp() orders a warp's steps, so that no warp waits for another.
// A chunk is CHUNK positions; the full-width entry gives each (row, chunk)
// pair to its own warp (nothing is carried between chunks, so a launch of a
// few long rows still fills every SM), the compacting entry gives a whole
// row to one warp, which walks its chunks in order and carries the row's
// count in a register.  Each warp owns a slice of dynamic shared memory
// (Slice): the chunk's codes with halos of w - 1 positions on both sides and
// k - 1 codes on the right, staged with 16-byte loads where rows start on 16
// bytes; then, for every staged position, its hash, direction, a window key
// and a mark.  The launcher takes fewer warps a block where a slice is large
// and opts in to more than 48 KB a block where w needs it.
//   k-mers: lane l rolls the hashes of a contiguous run of staged positions
//     (an odd run, so that a step's stores hit 32 banks): k - 1 codes fill
//     its first k-mer, then one code a position; an invalid code enters as 0
//     (is_fw is defined on it) and restarts the run of valid codes.
//   window rule: the mask is the set of first argmins of the windows of w
//     positions that lie inside the row (the a' + b' rule above says the
//     same).  A key is (unsigned hash << 32 | staged index), so the least key
//     of a span is its first argmin; log2 w passes build the least key of
//     every span of 2^j, a window's is the least of two overlapping spans,
//     and each window of the chunk marks its argmin.
//   output: positions are striped over the lanes, p = c0 + 32 i + lane.  The
//     compacting entry ranks a step's mask bits by one ballot and a
//     popcount, which is position order, so a step's set lanes write
//     consecutive columns and no per-warp table or second pass is needed;
//     the same warp writes the row's (BIG, 0, 0) tail after its last chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;               // positions of one chunk
constexpr int MAX_WARPS = 4;             // warps a block, fewer at large w
constexpr int32_t BIG = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_UNASKED = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr int SMEM_MAX = 227 * 1024;

// Hashes a lane rolls in one chunk: an odd run, so that the lanes' stores
// of one step fall in 32 different banks.
__host__ __device__ inline int lane_run(int n_hashes) {
  return ((n_hashes + 31) / 32) | 1;
}

// Bytes of one warp's slice: the codes (staged from a 16-byte boundary, so
// up to 15 bytes before the first staged position), then for 32 lane runs of
// staged positions the window keys (uint64), hashes (int32), directions and
// marks (bytes); rounded up to 16.
struct Slice {
  int run, n_codes, bytes;
  __host__ __device__ Slice(int k, int w) {
    run = lane_run(CHUNK + 2 * (w - 1));
    n_codes = (15 + 32 * run + k - 1 + 15) & ~15;
    bytes = (n_codes + 32 * run * 14 + 15) & ~15;
  }
};

template <bool COMPACT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
minimizer_front_kernel(const int8_t* __restrict__ reads, long long units,
                       long long n_chunks, int L, int k, int w, int S,
                       bool wide_loads, int32_t* __restrict__ out_h,
                       uint8_t* __restrict__ out_fw,
                       uint8_t* __restrict__ out_mask,
                       int32_t* __restrict__ out_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long unit = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (unit >= units) return;              // the whole warp; no barrier follows
  const int halo = w - 1;
  const Slice sl(k, w);
  int8_t* code_s = reinterpret_cast<int8_t*>(smem_raw + warp * sl.bytes);
  uint64_t* key_s = reinterpret_cast<uint64_t*>(code_s + sl.n_codes);
  int32_t* hs_s = reinterpret_cast<int32_t*>(key_s + 32 * sl.run);
  uint8_t* fw_s = reinterpret_cast<uint8_t*>(hs_s + 32 * sl.run);
  uint8_t* mark_s = fw_s + 32 * sl.run;

  const int P = L - k + 1;
  const long long row = COMPACT ? unit : unit / n_chunks;
  const int8_t* rd = reads + row * (long long)L;
  const long long out_row = row * (long long)(COMPACT ? S : P);
  const int first = COMPACT ? 0 : (int)(unit - row * n_chunks) * CHUNK;
  const int end = COMPACT ? P : min(first + CHUNK, P);
  const unsigned lanes_below = (1u << lane) - 1u;
  // At k = 16 the k-mer fills the word: a shift by 32 is undefined.
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const int span_log = 31 - __clz(w);     // the largest power of 2 <= w
  int count = 0;         // minimizers of the row before this step (uniform)

  for (int c0 = first; c0 < end; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);     // positions of this chunk
    const int q0 = c0 - halo;             // first staged position
    const int run = lane_run(n + 2 * halo);
    // Codes from a0 = q0 rounded down to 16: code_s[off + i] is code q0 + i;
    // codes past the row's edges read as 4 (invalid).
    const int off = q0 & 15, a0 = q0 - off;
    const int n_stage = (off + 32 * run + k - 1 + 15) & ~15;
    if (wide_loads) {                     // rows start on 16 bytes, L % 16 == 0
      for (int u = lane; 16 * u < n_stage; u += 32) {
        const int c = a0 + 16 * u;
        int4 v = make_int4(0x04040404, 0x04040404, 0x04040404, 0x04040404);
        if (c >= 0 && c < L) v = *reinterpret_cast<const int4*>(rd + c);
        reinterpret_cast<int4*>(code_s)[u] = v;
      }
    } else {
      for (int i = lane; i < n_stage; i += 32) {
        const int c = a0 + i;
        code_s[i] = (c >= 0 && c < L) ? rd[c] : (int8_t)4;
      }
    }
    __syncwarp();
    // Lane l rolls staged positions l * run ... l * run + run - 1; positions
    // past the row's edges meet an invalid code, so they hash to BIG.
    {
      const int8_t* cs = code_s + off + lane * run;
      uint32_t fw = 0, rv = 0;
      int valid_run = 0;
      for (int t = 0; t < run + k - 1; ++t) {
        uint32_t c = (uint8_t)cs[t];
        const bool valid = c < 4u;
        c = valid ? c : 0u;
        fw = ((fw << 2) | c) & kmask;
        rv = (rv >> 2) | ((3u - c) << (2 * (k - 1)));
        valid_run = valid ? valid_run + 1 : 0;
        if (t >= k - 1) {
          const bool is_fw = fw <= rv;
          uint32_t x = ~(is_fw ? fw : rv);
          x ^= x >> 16;
          x *= 0x85EBCA6Bu;
          x ^= x >> 13;
          const int i = lane * run + t - (k - 1);
          const uint32_t u = valid_run >= k ? x : 0xFFFFFFFFu;  // unsigned view
          hs_s[i] = (int32_t)(u ^ 0x80000000u);
          key_s[i] = ((uint64_t)u << 32) | (uint32_t)i;
          fw_s[i] = is_fw;
          mark_s[i] = 0;
        }
      }
    }
    __syncwarp();
    // key_s[i] becomes the least key of staged positions i .. i + 2^j - 1 for
    // j = 1 .. span_log (a key orders by hash, then by position: its least is
    // the first argmin).  A step loads, then stores, so no lane reads a key
    // that another has already replaced.
    const int n_st = n + 2 * halo;        // staged positions of this chunk
    for (int j = 1; j <= span_log; ++j) {
      const int d = 1 << (j - 1);
      const int last = n_st - 2 * d;      // the last key this level needs
      for (int i0 = 0; i0 <= last; i0 += 32) {
        const int i = i0 + lane;
        uint64_t x = 0, y = 0;
        if (i <= last) { x = key_s[i]; y = key_s[i + d]; }
        __syncwarp();
        if (i <= last) key_s[i] = y < x ? y : x;
        __syncwarp();
      }
    }
    // Every window of w positions inside the row and touching the chunk
    // marks its first argmin: the least of two overlapping spans.
    {
      const int s_lo = max(0, c0 - halo), s_hi = min(c0 + n - 1, P - w);
      const int d = w - (1 << span_log);
      for (int s = s_lo + lane; s <= s_hi; s += 32) {
        const uint64_t x = key_s[s - q0], y = key_s[s - q0 + d];
        mark_s[(uint32_t)(y < x ? y : x)] = 1;
      }
    }
    __syncwarp();

    for (int j0 = 0; j0 < n; j0 += 32) {  // one step: 32 positions
      const int j = j0 + lane;
      const int p = c0 + j;
      const int c = j + halo;             // this position in hs_s
      int32_t h = BIG;
      uint8_t f = 0;
      bool m = false;
      if (j < n) {
        h = hs_s[c];
        f = fw_s[c];
        m = mark_s[c] && h != BIG;
      }
      if (!COMPACT) {
        if (j < n) {
          out_h[out_row + p] = h;
          out_fw[out_row + p] = f;
          out_mask[out_row + p] = m ? 1 : 0;
        }
      } else {
        const unsigned bal = __ballot_sync(FULL, m);
        const int r = count + __popc(bal & lanes_below);   // 0-based rank
        if (m && r < S) {
          out_h[out_row + r] = h;
          out_fw[out_row + r] = f;
          out_mask[out_row + r] = 1;
        }
        count += __popc(bal);
      }
    }
    __syncwarp();         // the next chunk overwrites the slice
  }

  if (COMPACT) {
    for (int s = min(count, S) + lane; s < S; s += 32) {
      out_h[out_row + s] = BIG;
      out_fw[out_row + s] = 0;
      out_mask[out_row + s] = 0;
    }
    if (lane == 0) out_total[row] = count;
  }
}

template <bool COMPACT>
int launch(const void* reads, long long B, int L, int k, int w, int S,
           void* out_h, void* out_fw, void* out_mask, void* out_total,
           void* stream) {
  if (k < 1 || k > 16 || w < 1 || w > 1024 || L < k || B < 0 ||
      B > 0x7fffffffLL || (COMPACT && S < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int P = L - k + 1;
  const long long n_chunks = (P + CHUNK - 1) / CHUNK;
  const long long units = COMPACT ? B : B * n_chunks;
  const int slice = Slice(k, w).bytes;
  const int warps = min(MAX_WARPS, SMEM_MAX / slice);
  const long long blocks = (units + warps - 1) / warps;
  const int smem = warps * slice;
  if (blocks > 0x7fffffffLL || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem > SMEM_UNASKED) {
    const cudaError_t err = cudaFuncSetAttribute(
        minimizer_front_kernel<COMPACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool wide_loads = ((uintptr_t)reads & 15) == 0 && (L & 15) == 0;
  minimizer_front_kernel<COMPACT>
      <<<(unsigned)blocks, warps * 32, smem, (cudaStream_t)stream>>>(
          (const int8_t*)reads, units, n_chunks, L, k, w, S, wide_loads,
          (int32_t*)out_h, (uint8_t*)out_fw, (uint8_t*)out_mask,
          (int32_t*)out_total);
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
