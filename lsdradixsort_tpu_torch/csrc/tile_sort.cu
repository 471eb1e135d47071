// Per-tile sorts for Hopper (sm_90a): a bitonic network for every word
// count, and a stable merge sort for the rider path (tile_merge, below).
//
// Replaces the Pallas kernels of lsdradixsort_tpu/kernels/tile_sort.py:
// sort_tiles (_bitonic_keys_kernel), sort_tiles_kv (_bitonic_kernel) and
// sort_tiles_multi (_bitonic_multi_kernel). Every tile of T = 2^tile_log2
// rows is sorted ascending by its "words": the key, then up to three more
// u32 words compared lexicographically (the compared payloads, one or two,
// then the row's index inside its tile when payloads ride). Word 1 is
// compared after XOR with `flip1` (0x80000000 compares it as a signed
// int32, the sort_tiles_kv rule). A pair whose words tie never swaps.
// Phase kl of the network is ascending unless bit kl of the row's index in
// its tile is set; the last phase (kl == tile_log2) is ascending everywhere.
//
// What bounds it on the H100: the network does log2(T)(log2(T)+1)/2
// compare-exchange stages, about 120 at the paths' 2^15-row tile, and the
// words cross device memory (3.35 TB/s) only once each way at best. The
// TPU kernel keeps the whole tile in VMEM for every stage; one SM's shared
// memory (227 KB) holds a 2^15-row tile of one word (128 KB) but not of 2,
// 3 or 4 words (256, 384 or 512 KB).
//
// One design for every word count, cluster_sort: one thread-block cluster
// of C CTAs a tile, each CTA holding R = 2^rows_log2 rows of every word in
// its shared memory, so the words cross device memory once each way. At
// the paths' 2^15-row tile, C = 1 for one word (128 KB, one CTA an SM,
// no cross-CTA stage), 2 for 2 and 3 words, 4 for 4. The host hands the
// kernel its schedule ("steps", kernels/tile_sort.py `tile_plan`); each
// step is one shared-memory round trip, in which each thread takes its
// groups of E = 2^G rows into registers one after another:
//   - a register group: the E rows that differ only in bits b..b+G-1 of the
//     row index, on which the thread runs up to G consecutive stages of one
//     phase (the set is closed under each stage's partner map i ^ 2^jl, and
//     the direction, bit kl of the row, is the same for all of it since kl
//     lies outside those bits). 22 round trips instead of 120 stages at
//     E = 64 (one word), 26 at E = 32 (two), 34 at E = 16 (three and
//     four); the first step runs phases 1..G straight from the load, the
//     last stores straight from registers;
//   - a cross-CTA stage (distance 2^jl >= R) first: each thread reads its
//     rows' partners from the partner CTA's shared memory (distributed
//     shared memory), keeps its own side of each pair (the min on the low
//     side of an ascending pair), and a cluster barrier keeps every read
//     ahead of any write; no CTA writes another's memory.
// What then bounds it is the integer pipe (half the rate of the FP32 one)
// and the shared-memory round trips: a compare-exchange of one word is a
// min and a max, of 2 words a 64-bit compare and selects, of 3 or 4 a
// subtract-with-borrow chain and one LOP3 a word and side. For one word
// at 2^27 rows on an H100 SXM (700 W) a round trip costs about 0.06 ms,
// against 0.036 for its 1 GiB at 128 B a clock an SM, and a stage of min
// and max about 0.008 ms on the integer pipe: 2.97 ms a sort at E = 64,
// 3.11 at E = 32 (the one CTA an SM waits at each step's barrier). Shared
// memory is swizzled, word w of local row i at w * RS + (i ^ ((i >> G) &
// 31)), so the 32 rows a warp touches per access lie in 32 banks at every
// b. Riders are gathered at the store by the index word, which never
// reaches device memory. Tiles larger than the cluster's span run their
// stages of distance >= C*R as device-memory passes (bitonic_stage), one
// thread a pair, and the cluster kernel finishes each phase's lower
// stages.
//
// Any n: the last tile may end before its 2^tile_log2 rows. Its rows from
// n on are never read, written or allocated. A CTA that reaches past n
// (decided once a CTA; full tiles run the code they ran before) holds
// them as all-ones compared words (word 1 after its flip1 XOR too) with
// their own in-tile indices, the tile's largest: under either design's
// compare they sort after every row that exists, which the CTA stores
// alone. A kv row equal to one (key all ones, value 0x7FFFFFFF) has the
// same words, so the stored rows do not change. Device-memory stages keep
// every row of a tile in device memory, so a schedule with them takes
// whole tiles (kernels/tile_sort.py sorts a short last tile through one
// tile of scratch).
//
// The merge design, tile_merge::cluster_sort, sorts the rider path's tiles
// (kernels/tile_sort.py `design`): (key, payload 0, index word) at the
// 2^15-row tile, every sort_tiles_multi call at ncmp = 2 with riders (the
// merge join, Q1's sums, each sort_lex pass of sort_records). It is exact
// because the index word is compared last and no two rows of a tile share
// it: the sorted order is unique, so a stable sort by (key, payload 0),
// ties in index order, gives the network's output bit for bit, riders
// included. A stable merge compares the two words as one 64-bit integer
// and carries the index uncompared: one compare a row a level, 11 levels,
// where the network makes 60 compare-exchanges of three words a row. A
// cluster of 4 CTAs a tile, 2^13 rows a CTA, 16 a thread (512 threads):
//   - each thread sorts its 16 consecutive rows in registers by (key,
//     payload 0, index) (the bitonic network above) and writes them to
//     shared memory: (key, payload 0) pairs, 8 bytes a row, and the
//     indices (16 bits) in an array beside them;
//   - 9 levels inside the CTA, each a stable merge of pairs of runs from
//     one buffer to the other: a thread writes 16 consecutive outputs, a
//     merge-path binary search for the first, then a sequential merge with
//     both candidate rows in registers (one 8-byte load and one index load
//     an output, selected, not branched on); a pad slot after every 16
//     rows keeps the 16 threads of a store in distinct banks;
//   - 2 levels across the cluster (pairs of CTAs, then all 4), each CTA
//     writing its 2^13 ranks of the merge: the two cuts of its ranks in the
//     two runs (256 probes a round, counted with __syncthreads_count, two
//     rounds), a copy of that window of rows from the CTAs that hold them
//     (distributed shared memory, each row read once) into its free
//     buffer, a cluster barrier, then a merge as inside the CTA. Merging
//     straight from the other CTAs' memory made each step wait on a remote
//     load: 59 % of a CTA's cycles;
//   - the CTA's ranks out, coalesced, and each rider gathered by the index
//     word from the tile's rows.
// Two buffers of 2^13 rows (10 bytes a row, with the pads) take 174 KB:
// one CTA an SM. What bounds it on the H100: the levels' shared-memory
// wavefronts (a random 8-byte and a random 2-byte load an output, with
// bank conflicts, and the searches' loads; a level costs the same at one
// CTA an SM and at two), the cluster barriers' waits and the windows'
// copies, and each rider's gather, whose random 4-byte loads move a
// 32-byte sector from L2 each. Carrying a lone rider in place of the
// index (no gather), the last level's outputs stored straight from
// registers, and two CTAs an SM (one buffer of rows, written back after
// each level) were each no faster on the card.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWords = 4;
constexpr int kStageThreads = 256;
constexpr int kMaxRiders = 16;
constexpr int kMaxSteps = 64;
constexpr int kSmemLimit = 232448;

struct Words {
  const uint32_t* src[kMaxWords];  // nullptr: the row's index in its tile
  uint32_t* dst[kMaxWords];        // nullptr: not stored (cluster_sort)
};

struct Riders {
  const uint32_t* src[kMaxRiders];
  uint32_t* dst[kMaxRiders];
  int count;
};

// One cluster launch's schedule, encoded as in kernels/tile_sort.py.
struct Steps {
  int count;
  int code[kMaxSteps];
};

struct Shape {
  int tile_log2;
  int rows_log2;
  uint32_t flip1;
  long long n;  // rows that exist: the last tile may end before its span
};

enum : int { kStage = 0, kFirst = 1, kGroup = 2 };

// kStage: a device-memory stage (kl, jl = jx). kFirst: phases 1..kl, all
// in registers (bits 0..G-1). kGroup: the cross-CTA stage jx (-1: none),
// then stages jhi..jlo (-1: none) in registers over bits b..b+G-1.
struct Step {
  int kind, kl, jx, jhi, jlo, b;
};

__host__ __device__ __forceinline__ Step decode(int c) {
  return Step{c & 3,
              (c >> 2) & 31,
              ((c >> 7) & 31) - 1,
              ((c >> 12) & 31) - 1,
              ((c >> 17) & 31) - 1,
              (c >> 22) & 31};
}

template <int W>
__device__ __forceinline__ bool greater(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        uint32_t flip1) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t f = w == 1 ? flip1 : 0u;
    const uint32_t x = a[w] ^ f, y = b[w] ^ f;
    if (x != y) return x > y;
  }
  return false;
}

// Ascending unless bit kl of the row's index in its tile is set; the last
// phase (kl == tile_log2) is ascending everywhere.
__device__ __forceinline__ bool ascending(long long row, int kl,
                                          int tile_log2) {
  return kl >= tile_log2 || ((row >> kl) & 1) == 0;
}

// One compare-exchange stage at distance 2^jl over device memory, in
// place on io.dst: one thread per pair.
template <int W>
__global__ void __launch_bounds__(kStageThreads)
bitonic_stage(Words io, long long npairs, int tile_log2, int kl, int jl,
              uint32_t flip1) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npairs) return;
  const long long lo = ((p >> jl) << (jl + 1)) | (p & ((1LL << jl) - 1));
  const long long hi = lo + (1LL << jl);
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = io.dst[w][lo];
    b[w] = io.dst[w][hi];
  }
  const bool up = ascending(lo, kl, tile_log2);
  if (up ? greater<W>(a, b, flip1) : greater<W>(b, a, flip1)) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      io.dst[w][lo] = b[w];
      io.dst[w][hi] = a[w];
    }
  }
}

// ---- cluster_sort ------------------------------------------------------------

template <int G>
__device__ __forceinline__ uint32_t swizzle(uint32_t i) {
  return i ^ ((i >> G) & 31u);
}

// Whether row a orders after row b: its words compared lexicographically
// as one 64- or 128-bit integer (word 1 already XORed with flip1), so the
// compare is one chain of extended integer compares.
template <int W>
__device__ __forceinline__ bool greater_row(const uint32_t (&a)[W],
                                            const uint32_t (&b)[W]) {
  using u64 = unsigned long long;
  if constexpr (W == 1) {
    return a[0] > b[0];
  } else if constexpr (W == 2) {
    return ((static_cast<u64>(a[0]) << 32) | a[1]) >
           ((static_cast<u64>(b[0]) << 32) | b[1]);
  } else {
    const u64 x = (static_cast<u64>(a[0]) << 32) | a[1];
    const u64 y = (static_cast<u64>(b[0]) << 32) | b[1];
    // words (0, 1, 2[, 3]) as the 128-bit integer whose high half is word 0
    // (W = 3) or words 0, 1 (W = 4)
    using u128 = unsigned __int128;
    const u64 xh = W == 3 ? a[0] : x, yh = W == 3 ? b[0] : y;
    const u64 xl = W == 3 ? (static_cast<u64>(a[1]) << 32) | a[2]
                          : (static_cast<u64>(a[2]) << 32) | a[3];
    const u64 yl = W == 3 ? (static_cast<u64>(b[1]) << 32) | b[2]
                          : (static_cast<u64>(b[2]) << 32) | b[3];
    return ((static_cast<u128>(xh) << 64) | xl) >
           ((static_cast<u128>(yh) << 64) | yl);
  }
}

// All ones if row a (3 or 4 words) orders after row b, else 0: the borrow
// out of b - a, taken word by word from the last (one subtract with borrow
// a word).
template <int W>
__device__ __forceinline__ uint32_t greater_mask(const uint32_t (&a)[W],
                                                 const uint32_t (&b)[W]) {
  static_assert(W == 3 || W == 4, "two words compare as one 64-bit value");
#ifdef __CUDA_ARCH__
  uint32_t m;
  if constexpr (W == 3) {
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %6, %3;\n\t"
        "subc.cc.u32 t, %5, %2;\n\t"
        "subc.cc.u32 t, %4, %1;\n\t"
        "subc.u32 %0, 0, 0;\n\t}"
        : "=r"(m)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(b[0]), "r"(b[1]), "r"(b[2]));
  } else {
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %8, %4;\n\t"
        "subc.cc.u32 t, %7, %3;\n\t"
        "subc.cc.u32 t, %6, %2;\n\t"
        "subc.cc.u32 t, %5, %1;\n\t"
        "subc.u32 %0, 0, 0;\n\t}"
        : "=r"(m)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(b[2]), "r"(b[3]));
  }
  return m;
#else
  return greater_row<W>(a, b) ? ~0u : 0u;
#endif
}

// Compare-exchange of register rows e < f: the larger to f; tied rows
// stay. One word is a min and a max (equal keys are identical, so a tie
// needs no order); two words select by the predicate of one 64-bit
// compare; three or four by the borrow mask, with one LOP3 a word and side
// (fewer integer instructions than a compare chain and selects).
template <int W, int E>
__device__ __forceinline__ void exchange(uint32_t (&v)[W][E], int e,
                                         int f) {
  if constexpr (W == 1) {
    const uint32_t a = v[0][e], b = v[0][f];
    v[0][e] = min(a, b);
    v[0][f] = max(a, b);
  } else {
    uint32_t a[W], b[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      a[w] = v[w][e];
      b[w] = v[w][f];
    }
    if constexpr (W >= 3) {
      const uint32_t m = greater_mask<W>(a, b);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        v[w][e] = (a[w] & ~m) | (b[w] & m);
        v[w][f] = (b[w] & ~m) | (a[w] & m);
      }
    } else {
      const bool swap = greater_row<W>(a, b);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        v[w][e] = swap ? b[w] : a[w];
        v[w][f] = swap ? a[w] : b[w];
      }
    }
  }
}

// The N stages s = N-1..0 of one phase over the thread's E rows (row e
// against e | 2^s), in one direction. N is a template parameter so that a
// step runs without a branch between its stages.
template <int W, int G, int N, bool DOWN>
__device__ __forceinline__ void stages(uint32_t (&v)[W][1 << G]) {
#pragma unroll
  for (int s = N - 1; s >= 0; --s) {
#pragma unroll
    for (int e = 0; e < (1 << G); ++e) {
      if (e & (1 << s)) continue;
      if (DOWN) {
        exchange<W, 1 << G>(v, e | (1 << s), e);
      } else {
        exchange<W, 1 << G>(v, e, e | (1 << s));
      }
    }
  }
}

template <int W, int G, bool DOWN>
__device__ __forceinline__ void stages_n(uint32_t (&v)[W][1 << G], int n) {
  switch (n) {
    case 1: stages<W, G, 1, DOWN>(v); break;
    case 2: stages<W, G, 2, DOWN>(v); break;
    case 3: stages<W, G, 3, DOWN>(v); break;
    case 4: stages<W, G, 4, DOWN>(v); break;
    case 5:
      if constexpr (G >= 5) stages<W, G, 5, DOWN>(v);
      break;
    default:
      if constexpr (G >= 6) stages<W, G, 6, DOWN>(v);
      break;
  }
}

// Stages b + n - 1 .. b of one phase on the thread's rows (the rows over
// bits b..b+G-1, n <= G), all in one direction: a branch, the same for a
// whole warp but in the first phases.
template <int W, int G>
__device__ __forceinline__ void group_stages(uint32_t (&v)[W][1 << G], int n,
                                             bool down) {
  if (down) {
    stages_n<W, G, true>(v, n);
  } else {
    stages_n<W, G, false>(v, n);
  }
}

// Phases 1..kg (kg <= G) on the thread's E consecutive rows; row0 is the
// tile index of its first row (bits 0..G-1 clear). Below phase G the
// direction of a pair is bit k of e, known here; phase G's is bit G of
// row0, the same for all the thread's rows.
template <int W, int G>
__device__ __forceinline__ void first_phases(uint32_t (&v)[W][1 << G],
                                             int kg, int t, uint32_t row0) {
  constexpr int E = 1 << G;
#pragma unroll
  for (int k = 1; k < G; ++k) {
    if (k > kg) continue;
#pragma unroll
    for (int j = k - 1; j >= 0; --j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & (1 << j)) continue;
        const int f = e | (1 << j);
        if (k < t && ((e >> k) & 1)) {
          exchange<W, E>(v, f, e);
        } else {
          exchange<W, E>(v, e, f);
        }
      }
    }
  }
  if (kg == G) {
    group_stages<W, G>(v, G, G < t && ((row0 >> G) & 1));
  }
}

// Device memory <-> registers for the thread's rows base | e << b of the
// CTA starting at global row cta_base: 16-byte vectors where the rows are
// consecutive (b == 0) and the pointer allows, words otherwise. Word 1 is
// XORed with flip1 on the way in and out; a null source is the row's index
// in its tile. In a CTA that reaches past the last row (ragged: only its
// first `live` rows exist), the rows from n on are neither read nor
// written: they hold all-ones words (the largest, word 1 after its XOR
// too) and keep their index, the largest of their tile, so they sort after
// every row that exists.
template <int W, int G>
__device__ __forceinline__ void load_rows(uint32_t (&v)[W][1 << G],
                                          const Words& io, const Shape& sh,
                                          long long cta_base,
                                          uint32_t cta_off, uint32_t base,
                                          int b, bool ragged, uint32_t live) {
  constexpr int E = 1 << G;
  const uint32_t tmask = (1u << sh.tile_log2) - 1u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t f = w == 1 ? sh.flip1 : 0u;
    const uint32_t* s = io.src[w];
    if (s == nullptr) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[w][e] = (cta_off | base | (static_cast<uint32_t>(e) << b)) & tmask;
    } else if (ragged) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t l = base | (static_cast<uint32_t>(e) << b);
        v[w][e] = l < live ? s[cta_base + l] ^ f : ~0u;
      }
    } else if (b == 0 &&
               (reinterpret_cast<uintptr_t>(s + cta_base) & 15) == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(s + cta_base + base);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const uint4 x = p[q];
        v[w][4 * q] = x.x ^ f;
        v[w][4 * q + 1] = x.y ^ f;
        v[w][4 * q + 2] = x.z ^ f;
        v[w][4 * q + 3] = x.w ^ f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[w][e] = s[cta_base + (base | (static_cast<uint32_t>(e) << b))] ^ f;
    }
  }
}

template <int W, int G>
__device__ __forceinline__ void store_rows(const uint32_t (&v)[W][1 << G],
                                           const Words& io, const Riders& rd,
                                           const Shape& sh,
                                           long long cta_base, uint32_t base,
                                           int b, bool ragged, uint32_t live) {
  constexpr int E = 1 << G;
  const long long tile_mask = (1LL << sh.tile_log2) - 1;
  auto local = [&](int e) { return base | (static_cast<uint32_t>(e) << b); };
  auto put = [&](uint32_t* d, const uint32_t (&x)[E]) {
    if (ragged) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (local(e) < live) d[cta_base + local(e)] = x[e];
    } else if (b == 0 &&
               (reinterpret_cast<uintptr_t>(d + cta_base) & 15) == 0) {
      uint4* p = reinterpret_cast<uint4*>(d + cta_base + base);
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        p[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                          x[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[cta_base + local(e)] = x[e];
    }
  };
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (io.dst[w] == nullptr) continue;
    const uint32_t f = w == 1 ? sh.flip1 : 0u;
    uint32_t x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = v[w][e] ^ f;
    put(io.dst[w], x);
  }
  // riders: each output row takes the rider of the row its index word
  // names (a row that exists names one that exists: those sort first)
  for (int k = 0; k < rd.count; ++k) {
    uint32_t x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long g = cta_base + local(e);
      x[e] = !ragged || local(e) < live
                 ? rd.src[k][(g & ~tile_mask) + v[W - 1][e]]
                 : 0u;
    }
    put(rd.dst[k], x);
  }
}

// Shared-memory offsets of a thread's rows base | e << b: row e at
// pb ^ q(e), where q is linear in e (the swizzle is an XOR of the row's
// bits), so q(e) is the XOR of q(2^k) over the bits k of e.
template <int G>
struct Offsets {
  uint32_t pb;
  uint32_t qb[G];
  __device__ __forceinline__ Offsets(uint32_t base, int b)
      : pb(swizzle<G>(base)) {
#pragma unroll
    for (int k = 0; k < G; ++k) qb[k] = swizzle<G>(1u << (b + k));
  }
  __device__ __forceinline__ uint32_t operator()(int e) const {
    uint32_t p = pb;
#pragma unroll
    for (int k = 0; k < G; ++k)
      if ((e >> k) & 1) p ^= qb[k];
    return p;
  }
};

template <int W, int G, int RS>
__device__ __forceinline__ void read_smem(uint32_t (&v)[W][1 << G],
                                          const uint32_t* sm,
                                          const Offsets<G>& at) {
#pragma unroll
  for (int e = 0; e < (1 << G); ++e) {
    const uint32_t* p = sm + at(e);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w][e] = p[w * RS];
  }
}

template <int W, int G, int RS>
__device__ __forceinline__ void write_smem(const uint32_t (&v)[W][1 << G],
                                           uint32_t* sm,
                                           const Offsets<G>& at) {
#pragma unroll
  for (int e = 0; e < (1 << G); ++e) {
    uint32_t* p = sm + at(e);
#pragma unroll
    for (int w = 0; w < W; ++w) p[w * RS] = v[w][e];
  }
}

// One cluster of C CTAs a span of C * 2^rows_log2 rows (or one CTA a run of
// whole tiles), running `prog`; see the header. A thread holds E rows at a
// time and takes the CTA's 2^rows_log2 / (E * blockDim.x) groups of them
// in turn at every step.
template <int W, int G, int THREADS, int RS>
__global__ void __launch_bounds__(THREADS, 1)
cluster_sort(Words io, Riders rd, Steps prog, Shape sh) {
  constexpr int E = 1 << G;
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = sh.rows_log2;
  const int t = sh.tile_log2;
  const uint32_t groups = (1u << (r - G)) / blockDim.x;
  const uint32_t rank = cluster.block_rank();
  const long long cta_base = static_cast<long long>(blockIdx.x) << r;
  const uint32_t cta_off =
      static_cast<uint32_t>(cta_base) & ((1u << t) - 1u);
  // the CTA's rows that exist: all but in the last tile's CTAs
  const long long left = sh.n - cta_base;
  const uint32_t live = left >= (1LL << r) ? 1u << r
                        : left > 0        ? static_cast<uint32_t>(left)
                                          : 0u;
  const bool ragged = live != 1u << r;
  uint32_t v[W][E];
  for (int i = 0; i < prog.count; ++i) {
    const Step st = decode(prog.code[i]);
    const int b = st.b;
    const bool from_global = i == 0 && st.jx < 0;
    if (i == 0 && st.jx >= 0) {
      // a cross-CTA stage first: the partner must hold its rows first
      for (uint32_t l = threadIdx.x; l < (1u << r); l += blockDim.x) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t* s = io.src[w];
          const uint32_t f = w == 1 ? sh.flip1 : 0u;
          sm[w * RS + swizzle<G>(l)] =
              !s ? (cta_off | l) & ((1u << t) - 1u)
              : !ragged || l < live ? s[cta_base + l] ^ f
                                    : ~0u;
        }
      }
    }
    if (st.jx >= 0) {
      cluster.sync();  // the partner's rows are in place
    } else if (!from_global) {
      __syncthreads();
    }
    for (uint32_t k = 0; k < groups; ++k) {
      // the group's rows: its index with bits b..b+G-1 opened for e
      const uint32_t g = threadIdx.x + k * blockDim.x;
      const uint32_t base = (g & ((1u << b) - 1u)) | ((g >> b) << (b + G));
      const Offsets<G> at(base, b);
      if (from_global) {
        load_rows<W, G>(v, io, sh, cta_base, cta_off, base, b, ragged,
                        live);
      } else {
        read_smem<W, G, RS>(v, sm, at);
      }
      if (st.kind == kFirst) {
        first_phases<W, G>(v, st.kl, t, cta_off | base);
      } else {
        if (st.jx >= 0) {
          const int jb = st.jx - r;
          const uint32_t* remote =
              cluster.map_shared_rank(sm, rank ^ (1u << jb));
          const bool low = ((rank >> jb) & 1u) == 0;
          const bool up = !(st.kl < t && ((cta_off >> st.kl) & 1u));
          const bool keep_min = low == up;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const uint32_t* p = remote + at(e);
            uint32_t a[W], o[W];
#pragma unroll
            for (int w = 0; w < W; ++w) {
              a[w] = v[w][e];
              o[w] = p[w * RS];
            }
            const bool take =
                keep_min ? greater_row<W>(a, o) : greater_row<W>(o, a);
#pragma unroll
            for (int w = 0; w < W; ++w) v[w][e] = take ? o[w] : a[w];
          }
          // every read of this group's rows, here and in the partner, is
          // done before they are written; the rows of later groups are
          // untouched until then
          cluster.sync();
        }
        if (st.jhi >= 0) {
          const bool down =
              st.kl < t && (((cta_off | base) >> st.kl) & 1u);
          group_stages<W, G>(v, st.jhi - st.jlo + 1, down);
        }
      }
      if (i + 1 == prog.count) {
        store_rows<W, G>(v, io, rd, sh, cta_base, base, b, ragged, live);
      } else {
        write_smem<W, G, RS>(v, sm, at);
      }
    }
  }
}

constexpr int imin(int a, int b) { return a < b ? a : b; }

// The built (words, log2 E) pairs: the threads of a full CTA, which set
// its registers (65536 / threads), and log2 of the most rows a CTA holds,
// the stride of a word in shared memory; 0 where the pair is not built
// (kernels/tile_sort.py GEOMETRY names the pair each word count uses).
constexpr int max_threads(int W, int G) {
  return (W == 1 && G == 6) || (W == 2 && G == 5) || (W == 3 && G == 4) ||
                 (W == 4 && G == 4)
             ? 512
             : 0;
}
constexpr int max_rows_log2(int W, int G) {
  return max_threads(W, G) ? (W == 1 ? 15 : W == 4 ? 13 : 14) : 0;
}

// Whether `code` is a schedule the kernels can run without leaving their
// rows: fields in range, a cluster run of at most kMaxSteps steps, kFirst
// only first in a run, the last step of the program a store of whole
// vectors (b == 0), device-memory stages only where `stages` allows them.
// Whether it sorts is kernels/tile_sort.py's to show.
bool valid_program(const int* code, int ncode, int t, int r, int span,
                   int G, bool stages) {
  if (ncode < 1 || decode(code[0]).kind == kStage) return false;
  int run = 0;
  for (int i = 0; i < ncode; ++i) {
    const Step s = decode(code[i]);
    if (s.kl < 1 || s.kl > t) return false;
    if (s.kind == kStage) {
      if (!stages || s.jx < span || s.jx >= s.kl) return false;
      run = 0;
      continue;
    }
    if (++run > kMaxSteps) return false;
    if (s.kind == kFirst) {
      if (i != 0 || s.kl > G || s.jx >= 0 || s.b != 0) return false;
    } else if (s.kind == kGroup) {
      if (s.jx >= 0 && (s.jx < r || s.jx >= span || s.jx >= s.kl))
        return false;
      if (s.jx < 0 && s.jhi < 0) return false;
      if (s.jhi >= 0 && (s.jlo != s.b || s.jlo > s.jhi ||
                         s.jhi >= s.b + G || s.jhi >= s.kl))
        return false;
      if (s.b + G > r) return false;
    } else {
      return false;
    }
  }
  const Step last = decode(code[ncode - 1]);
  return last.kind != kStage && last.b == 0;
}

// A cluster_sort launch over `rows` rows (the rows its CTAs cover: sh.n
// rounded up to whole CTAs and tiles).
template <int W, int G>
cudaError_t launch_cluster(const Words& io, const Riders& rd,
                           const Steps& prog, const Shape& sh, int cluster,
                           long long rows, cudaStream_t stream) {
  constexpr int RS = 1 << max_rows_log2(W, G);
  auto kern = cluster_sort<W, G, max_threads(W, G), RS>;
  static_assert(W * RS * 4 <= kSmemLimit, "a CTA's words must fit");
  const int smem = W * RS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows >> sh.rows_log2));
  cfg.blockDim = dim3(static_cast<unsigned>(
      imin(max_threads(W, G), 1 << (sh.rows_log2 - G))));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, io, rd, prog, sh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Run the program over the `rows` rows its CTAs cover: each maximal run
// of cluster steps is one cluster_sort launch, each kStage one
// bitonic_stage pass in place on dst (only where rows == sh.n). Launches
// after the first work in place; the riders move in the last.
template <int W, int G>
cudaError_t sort_cluster(const Words& io, const Riders& rd, const int* code,
                         int ncode, const Shape& sh, int cluster,
                         long long rows, cudaStream_t stream) {
  Words inplace = io;
  for (int w = 0; w < W; ++w) inplace.src[w] = io.dst[w];
  const Riders none{};
  const long long npairs = rows / 2;
  const unsigned stage_blocks =
      static_cast<unsigned>((npairs + kStageThreads - 1) / kStageThreads);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < ncode;) {
    const Step s = decode(code[i]);
    if (s.kind == kStage) {
      bitonic_stage<W><<<stage_blocks, kStageThreads, 0, stream>>>(
          inplace, npairs, sh.tile_log2, s.kl, s.jx, sh.flip1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++i;
      continue;
    }
    Steps prog{};
    const int first = i;
    while (i < ncode && decode(code[i]).kind != kStage)
      prog.code[prog.count++] = code[i++];
    err = launch_cluster<W, G>(first == 0 ? io : inplace, i == ncode ? rd : none,
                            prog, sh, cluster, rows, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- the merge design (tile_merge::cluster_sort) ---------------------------

namespace tile_merge {

// A launch's compared words (the index word is made in the kernel) and
// where they go; a null output is not stored. Rows n and after of the last
// tile do not exist.
struct IO {
  const uint32_t* key;
  const uint32_t* val;
  uint32_t* key_out;
  uint32_t* val_out;
  long long n;
};

// Row (key, payload 0) as the 64-bit integer it orders by.
__device__ __forceinline__ unsigned long long word64(uint2 r) {
  return (static_cast<unsigned long long>(r.x) << 32) | r.y;
}

// The shared-memory slot of a CTA's row q: a pad slot after every 2^G
// rows, so that the 2^G consecutive rows each thread writes at a level
// start 2^G + 1 slots apart (16 threads' 8-byte stores, no bank conflict).
template <int G>
__device__ __forceinline__ int slot(int q) {
  return q + (q >> G);
}

// Slots of one buffer: the rows, their pads, and one slot past the end,
// which a finished run's read-ahead may touch.
template <int G, int RLOG>
__host__ __device__ constexpr int buffer_slots() {
  return (1 << RLOG) + (1 << (RLOG - G)) + 2;
}

// A CTA's shared memory: two buffers of the rows as (key, payload 0)
// pairs and of their indices in the tile (16 bits), a level's two cuts.
template <int G, int RLOG>
__host__ __device__ constexpr int merge_smem() {
  return buffer_slots<G, RLOG>() * 2 * (8 + 2) + 16;
}

// Row q of a level's input inside a CTA: kv and ix are its rows' buffers.
template <int G>
struct Rows {
  const uint2* kv;
  const uint16_t* ix;
  __device__ __forceinline__ uint2 row(int q) const { return kv[slot<G>(q)]; }
  __device__ __forceinline__ uint32_t index(int q) const {
    return ix[slot<G>(q)];
  }
};

// Row q of a level's input across the cluster, its rows in rank order:
// slot q mod 2^RLOG of CTA q >> RLOG's buffers (distributed shared
// memory).
template <int G, int RLOG>
struct ClusterRows {
  cg::cluster_group cluster;
  uint2* kv;
  uint16_t* ix;
  __device__ __forceinline__ uint2 row(int q) const {
    return *cluster.map_shared_rank(kv + slot<G>(q & ((1 << RLOG) - 1)),
                                    q >> RLOG);
  }
  __device__ __forceinline__ uint32_t index(int q) const {
    return *cluster.map_shared_rank(ix + slot<G>(q & ((1 << RLOG) - 1)),
                                    q >> RLOG);
  }
};

// The thread's 2^G outputs of a level: ranks [d, d + 2^G) of the stable
// merge of runs [0, mid) and [mid, hi) of `src` (ties go to the left run,
// whose rows have the lower indices), written to dkv's and dix's slots
// from row d. A merge-path search for the first, then a sequential merge
// with both candidate rows in registers: one row and one index read an
// output, the read position selected, not branched on.
template <int G, class R>
__device__ __forceinline__ void merge_out(const R& src, int mid, int hi,
                                          int d, uint2* dkv, uint16_t* dix) {
  constexpr int E = 1 << G;
  // a: rows of the left run among the merge's first d
  int a = d > hi - mid ? d - (hi - mid) : 0, e = d < mid ? d : mid;
  while (a < e) {
    const int h = (a + e) >> 1;
    if (word64(src.row(mid + d - 1 - h)) < word64(src.row(h))) {
      e = h;
    } else {
      a = h + 1;
    }
  }
  int pa = a, pb = mid + d - a;
  uint2 ra = src.row(pa), rb = src.row(pb);
  uint32_t xa = src.index(pa), xb = src.index(pb);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const bool take_a =
        (pb >= hi) | ((pa < mid) & (word64(ra) <= word64(rb)));
    dkv[slot<G>(d + k)] = take_a ? ra : rb;
    dix[slot<G>(d + k)] = static_cast<uint16_t>(take_a ? xa : xb);
    if (k + 1 < E) {
      pa += take_a;
      pb += !take_a;
      const int q = take_a ? pa : pb;
      const uint2 c = src.row(q);
      const uint32_t xc = src.index(q);
      ra = take_a ? c : ra;
      xa = take_a ? xc : xa;
      rb = take_a ? rb : c;
      xb = take_a ? xb : xc;
    }
  }
}

// The co-ranks of this CTA's first and last ranks, d0 and d0 + 2^RLOG, in
// the merge of A = src rows [lo, lo + w) and B = [lo + w, lo + 2w): the
// rows of A among the merge's first d. Half the CTA's threads a cut, each
// probing one candidate a round; "B's row before A's" turns from false to
// true once along A, so the false probes, counted by __syncthreads_count,
// narrow the cut H-fold a round.
template <int G, int RLOG, int C, class R>
__device__ __forceinline__ void coranks(const R& src, int lo, int w, int d0,
                                        int* cut) {
  constexpr int H = ((1 << RLOG) >> G) / 2;
  constexpr int HLOG = RLOG - G - 1;
  constexpr int CLOG = C == 8 ? 3 : C == 4 ? 2 : 1;
  // candidates span at most 2^(RLOG + CLOG - 1) rows
  constexpr int kRounds = (RLOG + CLOG - 1 + HLOG - 1) / HLOG;
  const int half = static_cast<int>(threadIdx.x) >= H;
  const int j = static_cast<int>(threadIdx.x) - half * H;
  const int d = d0 + (half << RLOG);
  int a = d > w ? d - w : 0, e = d < w ? d : w;
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    const int step = (e - a + H - 1) / H;
    const int h = a + j * step;
    const bool before_cut =
        h < e && !(word64(src.row(lo + w + d - 1 - h)) <
                   word64(src.row(lo + h)));
    const int n0 = __syncthreads_count(before_cut && !half);
    const int n1 = __syncthreads_count(before_cut && half);
    const int nf = half ? n1 : n0;
    const int na = nf == 0 ? a : a + (nf - 1) * step + 1;
    e = min(e, a + nf * step);
    a = na;
  }
  if (j == 0) cut[half] = a;
}

// One cluster of C CTAs a tile of C * 2^RLOG rows, each CTA 2^RLOG of
// them, 2^G a thread; see the header. The rows of a level move between
// the CTA's two buffers. A level across CTAs first copies the rows its
// ranks draw on (a window of each of the two runs, found by `coranks`)
// from the CTAs that hold them, then merges them here.
template <int G, int RLOG, int C>
__global__ void __launch_bounds__((1 << RLOG) >> G, 1)
cluster_sort(IO io, Riders rd) {
  constexpr int E = 1 << G, R = 1 << RLOG, THREADS = R >> G;
  constexpr int S = buffer_slots<G, RLOG>();
  extern __shared__ __align__(16) unsigned char merge_sm[];
  // buffer b's rows and indices, their addresses taken from merge_sm each
  // time (so the compiler sees shared memory); `in` holds a level's
  // input, in ^ 1 its output
  int in = 0;
  auto kv_of = [&](int b) {
    return reinterpret_cast<uint2*>(merge_sm) + b * S;
  };
  auto ix_of = [&](int b) {
    return reinterpret_cast<uint16_t*>(kv_of(2)) + b * S;
  };
  int* const cut = reinterpret_cast<int*>(ix_of(2));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) & (C - 1);
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) << RLOG;
  const long long tile = base - (static_cast<long long>(rank) << RLOG);
  // only the last tile's CTAs can reach past the last row: there the rows
  // from n on are neither read nor written, and sort after every row that
  // exists, as all-ones (key, payload 0) with the tile's largest indices
  const bool ragged = base + R > io.n;
  // the thread's 2^G consecutive rows, sorted in registers by (key,
  // payload 0, index): a bitonic network
  {
    uint32_t v[3][E];
    const long long r0 = base + (t << G);
    if (ragged) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool in = r0 + e < io.n;
        v[0][e] = in ? io.key[r0 + e] : ~0u;
        v[1][e] = in ? io.val[r0 + e] : ~0u;
      }
    } else if (((reinterpret_cast<uintptr_t>(io.key + base) |
                 reinterpret_cast<uintptr_t>(io.val + base)) & 15) == 0) {
      const uint4* pk = reinterpret_cast<const uint4*>(io.key + r0);
      const uint4* pv = reinterpret_cast<const uint4*>(io.val + r0);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const uint4 x = pk[q], y = pv[q];
        v[0][4 * q] = x.x, v[0][4 * q + 1] = x.y;
        v[0][4 * q + 2] = x.z, v[0][4 * q + 3] = x.w;
        v[1][4 * q] = y.x, v[1][4 * q + 1] = y.y;
        v[1][4 * q + 2] = y.z, v[1][4 * q + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[0][e] = io.key[r0 + e];
        v[1][e] = io.val[r0 + e];
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[2][e] = static_cast<uint32_t>((rank << RLOG) | (t << G) | e);
    first_phases<3, G>(v, G, G, 0u);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int s = slot<G>((t << G) + e);
      kv_of(0)[s] = make_uint2(v[0][e], v[1][e]);
      ix_of(0)[s] = static_cast<uint16_t>(v[2][e]);
    }
  }
  __syncthreads();
  // levels inside the CTA: runs of 2^G, 2^(G+1), .. rows merged in pairs;
  // a segment's slots start at slot(lo), so it reads and writes through
  // pointers offset by that
#pragma unroll
  for (int w = E; w < R; w <<= 1) {
    const int o0 = t << G, lo = o0 & ~(2 * w - 1), off = slot<G>(lo);
    merge_out<G>(Rows<G>{kv_of(in) + off, ix_of(in) + off}, w, 2 * w,
                 o0 - lo, kv_of(in ^ 1) + off, ix_of(in ^ 1) + off);
    __syncthreads();
    in ^= 1;
  }
  // levels across the cluster: each CTA's ranks of the merge of runs that
  // span 1, 2, .. CTAs (the cluster's rows in rank order)
#pragma unroll
  for (int w = R; w < C * R; w <<= 1) {
    cluster.sync();  // the level's input is in place in every CTA
    const ClusterRows<G, RLOG> src{cluster, kv_of(in), ix_of(in)};
    const int lo = (rank << RLOG) & ~(2 * w - 1), d0 = (rank << RLOG) - lo;
    coranks<G, RLOG, C>(src, lo, w, d0, cut);
    __syncthreads();
    // the window into the other buffer: A's rows [a0, a1), then B's
    // [d0 - a0, d0 + R - a1)
    const int a0 = cut[0], na = cut[1] - a0;
    const int b0 = lo + w + d0 - a0 - na;
    uint2 r[E];
    uint32_t x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t + e * THREADS;
      const int q = i < na ? lo + a0 + i : b0 + i;
      r[e] = src.row(q);
      x[e] = src.index(q);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int s = slot<G>(t + e * THREADS);
      kv_of(in ^ 1)[s] = r[e];
      ix_of(in ^ 1)[s] = static_cast<uint16_t>(x[e]);
    }
    // every CTA's copies are done: the level's input may be overwritten
    cluster.sync();
    merge_out<G>(Rows<G>{kv_of(in ^ 1), ix_of(in ^ 1)}, na, R, t << G,
                 kv_of(in), ix_of(in));
    __syncthreads();
  }
  // the CTA's ranks out, coalesced: the compared words, then each rider
  // gathered by the index word
  // (ranks from n on, in a ragged CTA, are the missing rows: not stored)
  const int ranks = ragged ? static_cast<int>(io.n - base) : R;
  if (io.key_out != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t + e * THREADS;
      const uint2 r = kv_of(in)[slot<G>(i)];
      if (!ragged || i < ranks) {
        io.key_out[base + i] = r.x;
        io.val_out[base + i] = r.y;
      }
    }
  }
  for (int k = 0; k < rd.count; ++k) {
    uint32_t y[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t + e * THREADS;
      y[e] = !ragged || i < ranks ? rd.src[k][tile + ix_of(in)[slot<G>(i)]]
                                  : 0u;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t + e * THREADS;
      if (!ragged || i < ranks) rd.dst[k][base + i] = y[e];
    }
  }
}

// The built geometry: clusters of 4 CTAs of 2^13 rows, 16 rows a thread
// (512 threads; 174 KB of shared memory a CTA). kernels/tile_sort.py
// MERGE_G, MERGE_ROWS_LOG2 and MERGE_CLUSTER mirror it.
constexpr int kG = 4, kRowsLog2 = 13, kCluster = 4;

template <int G, int RLOG, int C>
cudaError_t launch(const IO& io, const Riders& rd, long long n,
                   cudaStream_t stream) {
  auto kern = cluster_sort<G, RLOG, C>;
  constexpr int smem = merge_smem<G, RLOG>();
  static_assert(smem <= kSmemLimit, "a CTA's buffers must fit");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  // whole clusters: the last tile's CTAs past n sort only missing rows
  constexpr long long tile = static_cast<long long>(C) << RLOG;
  cfg.gridDim = dim3(static_cast<unsigned>((n + tile - 1) / tile * C));
  cfg.blockDim = dim3((1 << RLOG) >> G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kern, io, rd);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tile_merge

}  // namespace

// Sort every tile of 2^15 rows of (key, val, index) with the merge design
// (tile_merge::cluster_sort; see the header), the last tile ending at n
// (it may be short), the words compared unsigned, key first, ties in
// index order;
// rider_dst[k][row] = rider_src[k][tile_base + index]. key_out and val_out
// are both given or both null (not stored). Returns a cudaError_t; a
// refused cluster launch returns the occupancy query's error or
// cudaErrorLaunchOutOfResources.
extern "C" int lsd_sort_tiles_merge(const void* key, const void* val,
                                    void* key_out, void* val_out,
                                    long long n, const void* const* rider_src,
                                    void* const* rider_dst, int nriders,
                                    void* stream) {
  using namespace tile_merge;
  if (key == nullptr || val == nullptr || n < 0 ||
      (key_out == nullptr) != (val_out == nullptr) || nriders < 0 ||
      nriders > kMaxRiders) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const IO io{static_cast<const uint32_t*>(key),
              static_cast<const uint32_t*>(val),
              static_cast<uint32_t*>(key_out), static_cast<uint32_t*>(val_out),
              n};
  Riders rd{};
  rd.count = nriders;
  for (int k = 0; k < nriders; ++k) {
    rd.src[k] = static_cast<const uint32_t*>(rider_src[k]);
    rd.dst[k] = static_cast<uint32_t*>(rider_dst[k]);
  }
  return launch<kG, kRowsLog2, kCluster>(io, rd, n,
                                         static_cast<cudaStream_t>(stream));
}

// Sort every tile of 2^tile_log2 rows of `nwords` (1..4) u32 words, the
// last tile ending at n (it may be short), 1 <= tile_log2 <= 30, with
// cluster_sort: clusters of `cluster` CTAs of 2^rows_log2 rows each, E =
// 2^G rows a thread at a time (a built pair of words and G, see
// max_threads), by the schedule `code` (kernels/tile_sort.py `tile_plan`).
// src[w] == nullptr makes word w the row's index in its tile; dst[w] ==
// nullptr leaves it unstored. A schedule with a device-memory stage needs
// every word stored and n a multiple of the tile (its stages keep every
// row of a tile in device memory). With
// nriders > 0 the last word must be the index word, and
// rider_dst[k][row] = rider_src[k][tile_base + index]. Returns a
// cudaError_t: a refused cluster launch (no cluster of that size and
// shared memory fits the card) returns the occupancy query's error or
// cudaErrorLaunchOutOfResources.
extern "C" int lsd_sort_tiles(const void* const* src, void* const* dst,
                              int nwords, long long n, int tile_log2,
                              unsigned int flip1, int cluster, int rows_log2,
                              int G, const int* code, int ncode,
                              const void* const* rider_src,
                              void* const* rider_dst, int nriders,
                              void* stream) {
  if (nwords < 1 || nwords > kMaxWords || tile_log2 < 1 || tile_log2 > 30 ||
      n < 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  Words io{};
  bool stored_index = true;
  for (int w = 0; w < nwords; ++w) {
    io.src[w] = static_cast<const uint32_t*>(src[w]);
    io.dst[w] = static_cast<uint32_t*>(dst[w]);
    stored_index = stored_index && io.dst[w] != nullptr;
  }
  const int cluster_log2 = cluster == 4 ? 2 : (cluster == 2 ? 1 : 0);
  const int span = rows_log2 + cluster_log2;
  // the rows the CTAs cover: whole tiles, whole spans
  const long long tile = 1LL << tile_log2;
  const long long rows = (n + tile - 1) / tile * tile;
  if ((cluster != 1 && cluster != 2 && cluster != 4) || nriders < 0 ||
      nriders > kMaxRiders || G < 1 || G > 6 || rows_log2 < G ||
      rows_log2 > max_rows_log2(nwords, G) ||
      rows % (1LL << span) != 0 || (cluster > 1 && span > tile_log2) ||
      (nriders > 0 && io.src[nwords - 1] != nullptr) ||
      !valid_program(code, ncode, tile_log2, rows_log2, span, G,
                     stored_index && rows == n)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  Riders rd{};
  rd.count = nriders;
  for (int k = 0; k < nriders; ++k) {
    rd.src[k] = static_cast<const uint32_t*>(rider_src[k]);
    rd.dst[k] = static_cast<uint32_t*>(rider_dst[k]);
  }
  const Shape sh{tile_log2, rows_log2, flip1, n};
  switch (nwords * 8 + G) {
#define LSD_CASE(W, G1)                                                    \
  case W * 8 + G1:                                                         \
    return sort_cluster<W, G1>(io, rd, code, ncode, sh, cluster, rows, st);
    LSD_CASE(1, 6)
    LSD_CASE(2, 5)
    LSD_CASE(3, 4)
    LSD_CASE(4, 4)
#undef LSD_CASE
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* lsd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
