// Kernel K1: the counter-hash noise U(seed) (hash.cuh), drawn for a whole
// parameter tree in one launch and consumed where it is drawn.
//
// Replaces the Pallas kernel `_noise_kernel` / `zo_noise` of
// src/repro/kernels/zo_matmul.py.  The TPU kernel tiles one (K, N) field
// over a grid and draws each tile from its global coordinates.  On this
// path the reference never writes U out: XLA fuses the hash into its
// consumer (the direction accumulation `a + s * u` of core/aggregate.py
// and core/zo.py, and `theta + mu * U` of ops.perturb_tree).  This kernel
// does the same fusion by hand.  A launch takes a table of up to
// MAX_SEGMENTS segments, one per leaf, each a (rows, cols) view of U at a
// global (row_offset, col_offset) with its own seed and pointers, and one
// of three epilogues:
//   * field:      out = U                         (f32)
//   * accumulate: acc = acc + s * U               (f32, in place; s read
//                 from device memory, the product and the sum rounded
//                 apart, so it equals the tensor code `a + s * u`)
//   * perturb:    out = dtype(p + mu * U)          (p f32 or bf16; mu an
//                 f32, as PyTorch rounds a Python scalar; equals
//                 `(p.float() + mu * u).to(p.dtype)`)
// A segment flagged ZERO has U = 0 (a leaf without a seed: the
// accumulation adds s * 0, as the tensor code adds a zero direction).
// The gathered form `rows` (out[i, c] = U[ids[i], c], the embedding
// lookup's noise rows) is a kernel of its own with the same tiles.
//
// Tiles.  A segment is cut into 32 x 128 tiles; the launch's tiles are
// numbered segment after segment, and a block walks tiles in increasing
// order (grid stride), moving its segment cursor forward by the table's
// tile prefix sums (`tile0`).  A thread owns 4 consecutive columns and 4
// rows of a tile: the column terms of the hash (zo_mix_col) are formed
// once per tile, the row term (zo_mix_row) once per row, so an element
// costs the XOR and zo_mix_final.  Rows and columns come from the tile
// index by one 32-bit division per tile; element offsets are r * cols + c,
// never a division.  Where cols % 4 == 0 and the pointers are aligned
// (flag VEC) each row's 4 elements move as one 16-byte access (8 bytes
// for bf16); otherwise element by element, masked.
//
// Bound on the H100, per element: bytes 4 (field), 8 (accumulate: read
// and write acc) or 2 x sizeof(p) (perturb), over 3.35 TB/s.  The hash
// compiles to 4 LOP3 and 3 SHF (integer, 64 / clock / SM), 2 IMAD (64),
// one I2FP (a conversion, 16) and 3 FMUL + 1 FADD (128), per the CUDA
// programming guide's throughput table for compute capability 9.0, plus
// an FMUL and an FADD in the accumulate and perturb epilogues
// (chip_smoke.py prints the kernels' SASS opcode counts).  At 132 SMs
// that is ~16 us for the 50432 x 768 field against 46 us of bytes, so
// every mode is bound by bytes.  The table goes in by value as the
// kernel's parameter (3.6 KB of the 4 KB parameter space), so a launch
// needs no copy to the card.
#include "convert.cuh"
#include "hash.cuh"

namespace {

constexpr int MAX_SEGMENTS = 64;   // kernels/zo_matmul.py: MAX_SEGMENTS
constexpr int THREADS = 256;
constexpr int TILE_R = 32, TILE_C = 128;       // a warp spans 128 columns
constexpr int RPT = TILE_R / (THREADS / 32);   // rows per thread: 4

enum Mode { FIELD = 0, ACCUMULATE = 1, PERTURB = 2 };
enum Flag { BF16 = 1, ZERO = 2, VEC = 4 };

// kernels/zo_matmul.py: _Segment and _Table mirror these with ctypes
struct Segment {
  void* out;             // field: U; accumulate: acc; perturb: the output
  const void* in;        // perturb: p
  long long tile0;       // the segment's first tile in the launch
  unsigned rows, cols, seed, row_offset, col_offset;
  unsigned col_tiles;    // ceil(cols / TILE_C)
  unsigned flags, unused;
};
static_assert(sizeof(Segment) == 56, "Segment layout");

struct Table {
  Segment seg[MAX_SEGMENTS];
  long long tiles;       // all segments' tiles
  const float* scale;    // accumulate: s
  int n, mode;
  float mu;              // perturb
  int unused;
};
static_assert(sizeof(Table) == 64 * 56 + 32, "Table layout");

__device__ __forceinline__ float uniform_at(uint32_t rterm, uint32_t cterm) {
  return zo_bits_to_uniform(zo_mix_final(rterm ^ cterm));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    zo_noise_tree_kernel(const __grid_constant__ Table t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = 0;
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    while (s + 1 < t.n && tile >= t.seg[s + 1].tile0) ++s;
    const Segment& g = t.seg[s];
    const unsigned local = (unsigned)(tile - g.tile0);
    const unsigned tr = local / g.col_tiles, tc = local - tr * g.col_tiles;
    const unsigned c0 = tc * TILE_C + 4 * lane;
    if (c0 >= g.cols) continue;
    const int nc = min(4u, g.cols - c0);
    const bool zero = MODE == ACCUMULATE && (g.flags & ZERO);
    const bool vec = g.flags & VEC;
    uint32_t cterm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cterm[j] = zo_mix_col(g.col_offset + c0 + j);
    const float sc = MODE == ACCUMULATE ? *t.scale : 0.0f;

    // the rows' inputs first (accumulate: acc; perturb: p), so their loads
    // are in flight together
    float in[RPT][4];
    unsigned nr = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const unsigned r = tr * TILE_R + warp + 8 * i;
      if (r < g.rows) nr = i + 1;
      if (MODE == FIELD || r >= g.rows) continue;
      const size_t idx = (size_t)r * g.cols + c0;
      if (MODE == ACCUMULATE || !(g.flags & BF16)) {
        const float* src = MODE == ACCUMULATE ? (const float*)g.out
                                              : (const float*)g.in;
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(src + idx);
          in[i][0] = v.x, in[i][1] = v.y, in[i][2] = v.z, in[i][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) in[i][j] = j < nc ? src[idx + j] : 0.f;
        }
      } else {
        const __nv_bfloat16* src = (const __nv_bfloat16*)g.in + idx;
        if (vec) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          in[i][0] = __uint_as_float(v.x << 16);
          in[i][1] = __uint_as_float(v.x & 0xFFFF0000u);
          in[i][2] = __uint_as_float(v.y << 16);
          in[i][3] = __uint_as_float(v.y & 0xFFFF0000u);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            in[i][j] = j < nc ? __bfloat162float(src[j]) : 0.f;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i >= (int)nr) break;
      const unsigned r = tr * TILE_R + warp + 8 * i;
      const uint32_t rterm = zo_mix_row(g.seed, g.row_offset + r);
      const size_t idx = (size_t)r * g.cols + c0;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float u = zero ? 0.0f : uniform_at(rterm, cterm[j]);
        if (MODE == FIELD) v[j] = u;
        if (MODE == ACCUMULATE) v[j] = __fadd_rn(in[i][j], __fmul_rn(sc, u));
        if (MODE == PERTURB) v[j] = __fadd_rn(in[i][j], __fmul_rn(t.mu, u));
      }
      if (MODE == PERTURB && (g.flags & BF16)) {
        __nv_bfloat16* dst = (__nv_bfloat16*)g.out + idx;
        if (vec) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 w;
          w.x = *reinterpret_cast<const uint32_t*>(&lo);
          w.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(dst) = w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nc) dst[j] = __float2bfloat16_rn(v[j]);
        }
      } else {
        float* dst = (float*)g.out + idx;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nc) dst[j] = v[j];
        }
      }
    }
  }
}

// out[i, c] = U[ids[i], c]: tiles of 32 ids x 128 columns, the row term
// from the id
__global__ void __launch_bounds__(THREADS)
    zo_noise_rows_kernel(float* __restrict__ out,
                         const int32_t* __restrict__ ids, unsigned n_ids,
                         unsigned cols, unsigned col_tiles, unsigned tiles,
                         uint32_t seed) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = cols % 4 == 0 && (uintptr_t)out % 16 == 0;
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const unsigned tr = tile / col_tiles;
    const unsigned c0 = (tile - tr * col_tiles) * TILE_C + 4 * lane;
    if (c0 >= cols) continue;
    const int nc = min(4u, cols - c0);
    uint32_t cterm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cterm[j] = zo_mix_col(c0 + j);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const unsigned r = tr * TILE_R + warp + 8 * i;
      if (r >= n_ids) break;
      const uint32_t rterm = zo_mix_row(seed, (uint32_t)ids[r]);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = uniform_at(rterm, cterm[j]);
      float* dst = out + (size_t)r * cols + c0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nc) dst[j] = v[j];
      }
    }
  }
}

// As many blocks as the card holds at once (each walks its share of the
// tiles), fewer for a small launch.  Each kernel's occupancy is asked once.
unsigned grid_for(const void* kernel, long long tiles) {
  static const void* known[4] = {};
  static int resident[4] = {};
  int i = 0;
  while (i < 4 && known[i] != nullptr && known[i] != kernel) ++i;
  if (i == 4) return 0;
  if (known[i] == nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0) !=
            cudaSuccess ||
        per_sm <= 0)
      return 0;
    resident[i] = sms * per_sm;
    known[i] = kernel;
  }
  return (unsigned)(tiles < resident[i] ? tiles : resident[i]);
}

template <typename K>
int launch(K kernel, const Table& t, cudaStream_t s) {
  const unsigned grid = grid_for((const void*)kernel, t.tiles);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, THREADS, 0, s>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// `table` points to a host copy of Table (kernels/zo_matmul.py builds it);
// it is passed to the kernel by value.
extern "C" int zo_noise_tree(const void* table, void* stream) {
  const Table& t = *(const Table*)table;
  if (t.n <= 0 || t.n > MAX_SEGMENTS || t.tiles <= 0)
    return (int)cudaErrorInvalidValue;
  if (t.mode == ACCUMULATE && t.scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t.mode) {
    case FIELD:
      return launch(zo_noise_tree_kernel<FIELD>, t, s);
    case ACCUMULATE:
      return launch(zo_noise_tree_kernel<ACCUMULATE>, t, s);
    case PERTURB:
      return launch(zo_noise_tree_kernel<PERTURB>, t, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int zo_noise_rows(void* out, const void* ids, long long n_ids,
                             long long cols, unsigned int seed,
                             void* stream) {
  if (n_ids <= 0 || cols <= 0 || n_ids > 0xFFFFFFFFll || cols > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const unsigned col_tiles = (unsigned)((cols + TILE_C - 1) / TILE_C);
  const long long tiles = (n_ids + TILE_R - 1) / TILE_R * col_tiles;
  if (tiles > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_for((const void*)zo_noise_rows_kernel, tiles);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  zo_noise_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)out, (const int32_t*)ids, (unsigned)n_ids, (unsigned)cols,
      col_tiles, (unsigned)tiles, seed);
  return (int)cudaGetLastError();
}
