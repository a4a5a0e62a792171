// Hand-written Hopper (sm_90a) kernels of the unit-cost edit DP: the
// refine-borders family of the est-fact (STEP 2) device offload, the
// K-band problems whose band covers the matrix, and STEP 4's edit stats.
//
// rowmin_kernel replaces the XLA op
//   ops/align.py::batch_edit_rowmin (pintron_tpu/ops/align.py:177)
// of the JAX package: for every row of the edit DP of a pattern (rows)
// against a text window (columns), its minimum over columns 0..len1 and
// the FIRST column attaining it.  The results are int32, so the JAX
// op's int16 wire format and its argmin encoding bound are not needed.
// edit_score_kernel replaces the XLA op
//   ops/align.py::batch_edit_distance_score (pintron_tpu/ops/align.py:144):
// the one cell M[min(len2, max_rows)][len1] of the same DP.  Both run
// M[0][j] = j, M[r][0] = r and M[r][j] = min(M[r-1][j-1] + (t[j-1] !=
// p[r-1]), M[r-1][j] + 1, M[r][j-1] + 1), the pattern's character index
// clamped to its width as the plain op clamps it, characters compared
// as raw bytes (int8) for equality only.  The plain PyTorch versions in
// pintron_tpu_torch/ops/align.py are their reference.
//
// What bounds them on this card: neither the bytes nor the ALUs.  STEP
// 2's 24 rowmin launches on the two largest golden loci hold 2 to 1458
// problems of at most 30 pattern rows and 60 text columns, STEP 4
// launches one (256, 16, 16) batch a locus (python -m
// pintron_tpu_torch.measure_rowmin), so a launch is its launch latency
// plus one problem's chain of dependent cells, and where a launch is
// crowded, the instructions issued.  The long problems of the
// full-matrix K-band route (exons over 17 kb, budgets over 512) are a
// few problems of millions of cells: the same chain, len1 x len2 / 32
// cells a lane.
//
// The design: one __device__ sweep, edit_sweep, with two epilogues.
//   * One problem to a group of G lanes (G = 32, a warp, or G = 16, two
//     problems a warp), several warps a block, nothing shared between
//     them and no block barrier.  A group runs to its own len1 and len2,
//     so a padded problem (len2 = 0) runs no row and a launch is not
//     held to its longest problem.
//   * Lane l of a group holds R consecutive pattern rows and the group
//     sweeps the text columns as a skewed wavefront: at step s lane l
//     computes column j = s - l + 1 of its rows, top to bottom.  The
//     row above its first row arrives from lane l - 1 by one
//     __shfl_up_sync a step (lane l - 1 computed that column one step
//     earlier), and the value it received the step before is the
//     diagonal.  Along a row the left neighbour is the lane's own
//     previous value: no prefix scan.  Values are kept as X = M - i - j,
//     so a cell is one three-way minimum (__vimin3_s32, Hopper's DPX)
//     with no add on the chain, and row 0 and column 0 are 0.  A step
//     is straight-line code (the cell's update by selects, the steps in
//     fours), so the chain is a shuffle, a select and R minima.  The
//     text character travels along the lanes with the wavefront; group
//     lane 0 takes it, and after the first pass the row above the pass,
//     from a window loaded a group-width of steps ahead.  The R pattern
//     characters sit in registers.
//   * R and G come from the wrapper, from the row bucket (ops/kband.py
//     edit_layout): (1, 16) for the 16-row bucket and (2, 32) for the
//     64-row bucket, in one pass; R = 16 for longer patterns, in passes
//     of 32 x 16 = 512 rows: lane 31 keeps each column of the pass's
//     last row in a row buffer of len1 + 1 int32 a problem (device
//     memory, held by L2), which group lane 0 of the next pass reads a
//     group-width ahead.
//   * rowmin's epilogue: every row keeps its (least M - i, first column)
//     pair in registers, starting at (0, 0) for column 0 and replaced on
//     a strict < as j rises, so the first argmin falls out; a lane
//     writes its rows' pairs once, after its last column.  Only columns
//     0..len1 are swept and only rows 0..len2 written; rows past len2
//     stay unspecified.
//   * edit_score's epilogue: after the sweep a lane holds its rows'
//     values at column len1, and the lane holding row min(len2,
//     max_rows) writes it.  No width is capped: the text runs as far as
//     the row buffer the wrapper allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr unsigned kFull = 0xffffffffu;

// the larger of x over the problems of the warp (two when G = 16)
template <int G>
__device__ __forceinline__ int warp_max(int x) {
  if (G == 16) x = max(x, __shfl_xor_sync(kFull, x, 16));
  return x;
}

// One pass of the sweep: pattern rows p0 + 1 .. p0 + G * R of the edit
// DP of text t (n columns) against pattern p (rows rows; its m_cols
// characters, clamped) for the group of G lanes this lane is in.  Values
// are kept as X[i][j] = M[i][j] - i - j, so that row 0 and column 0 are
// 0 and a cell is one three-way minimum, X[i][j] = min(X[i][j-1],
// X[i-1][j], X[i-1][j-1] + (t[j-1] != p[i-1]) - 2).  kRowmin writes the
// pass's rows of V and P; otherwise the lane holding row ``rows`` writes
// *out = M[rows][n].  kFirst: the row above the pass is row 0, else it
// is read from the row buffer, where this pass leaves its last row when
// another pass follows.  A lane whose group has no problem (live false)
// passes rows = n = 0 and takes part in the warp's shuffles only.
template <int R, int G, bool kRowmin, bool kFirst>
__device__ __forceinline__ void edit_pass(
    const int8_t* __restrict__ t, int n, const int8_t* __restrict__ p,
    int m_cols, int rows, int p0, int32_t* rowbuf, int32_t* __restrict__ V,
    int32_t* __restrict__ P, int32_t* __restrict__ out, bool live) {
  constexpr int kPass = G * R;
  const int gl = threadIdx.x & (G - 1);  // the lane in its group
  const int i0 = p0 + gl * R;            // the row above the lane's strip
  const int lact = min(G, max(0, (rows - p0 + R - 1) / R));
  const bool keep = p0 + kPass < rows;   // the pass's last row feeds on
  int pc[R], x[R], by[R], arg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r + 1;
    pc[r] = i <= rows ? p[min(i, m_cols) - 1] : 0;
    x[r] = 0;    // X at column 0
    by[r] = 0;   // rowmin: the row's least M - i so far, at column 0
    arg[r] = 0;  // ... and its first column
  }
  int d = 0;    // X[i0][j-1], the diagonal of the strip's first row
  int bot = 0;  // the strip's last row at the lane's last column
  // group lane 0's inputs a group-width ahead: at step s, the text
  // character of column s + 1 and (after the first pass) the row above
  // the pass there, held by the group's lane s mod G
  int cur_t, nxt_t, cur_u = 0, nxt_u = 0;
  auto fetch = [&](int base, int& tv, int& uv) {
    const int j = base + gl + 1;
    tv = j <= n ? t[j - 1] : 0;
    if (!kFirst) uv = j <= n ? rowbuf[j] : 0;
  };
  fetch(0, cur_t, cur_u);
  fetch(G, nxt_t, nxt_u);
  int tch = __shfl_sync(kFull, cur_t, 0, G);  // the lane's character
  const int steps = lact > 0 && n > 0 ? n + lact - 1 : 0;
  const int wsteps = warp_max<G>(steps);
  for (int s0 = 0; s0 < wsteps; s0 += G) {
    if (s0 > 0) {
      cur_t = nxt_t;
      cur_u = nxt_u;
      fetch(s0 + G, nxt_t, nxt_u);
    }
    const int jb = s0 + 1 - gl;  // the lane's column at step s0
#pragma unroll(R <= 2 ? G : 1)
    for (int k = 0; k < G; ++k) {
      // the short strips run steps in fours, with no branch between
      // them: a step past a lane's last column changes nothing
      if ((R > 2 || k % 4 == 0) && s0 + k >= wsteps) break;
      // group lane 0's next character, everyone else's from the lane
      // before
      const int t0 = __shfl_sync(kFull, k < G - 1 ? cur_t : nxt_t,
                                 (k + 1) & (G - 1), G);
      const int t_in = __shfl_up_sync(kFull, tch, 1, G);
      int up = __shfl_up_sync(kFull, bot, 1, G);  // X[i0][j]
      if (kFirst) {
        if (gl == 0) up = 0;  // row 0
      } else {
        const int u0 = __shfl_sync(kFull, cur_u, k, G);
        if (gl == 0) up = u0;
      }
      const int j = jb + k;
      const bool act = gl < lact && j >= 1 && j <= n;
      int u = up, dg = d;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = __vimin3_s32(x[r], u, dg + (tch != pc[r]) - 2);
        dg = x[r];
        u = v;
        x[r] = act ? v : x[r];
        if (kRowmin) {
          const int y = v + j;  // M - i
          const bool better = act && y < by[r];
          by[r] = better ? y : by[r];
          arg[r] = better ? j : arg[r];
        }
      }
      bot = u;
      d = act ? up : d;
      if (keep && act && gl == G - 1) rowbuf[j] = bot;
      tch = gl == 0 ? t0 : t_in;
    }
  }
  __syncwarp();  // the row buffer, for the next pass's group lane 0
  if (!live || gl >= lact) return;
  if (kRowmin) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r + 1;
      if (i <= rows) {
        V[i] = by[r] + i;
        P[i] = arg[r];
      }
    }
  } else if (rows <= p0 + kPass && (rows - 1 - p0) / R == gl) {
    const int rr = (rows - 1 - p0) % R;
    int v = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == rr) v = x[r];
    *out = v + rows + n;
  }
}

// The whole DP of one problem a group: row 0, then the passes.
template <int R, int G, bool kRowmin>
__device__ __forceinline__ void edit_sweep(
    const int8_t* __restrict__ t, int n, const int8_t* __restrict__ p,
    int m_cols, int rows, int32_t* rowbuf, int32_t* __restrict__ V,
    int32_t* __restrict__ P, int32_t* __restrict__ out, bool live) {
  if (live && (threadIdx.x & (G - 1)) == 0) {
    if (kRowmin) {
      V[0] = 0;  // row 0: M[0][j] = j, least at column 0
      P[0] = 0;
    } else if (rows == 0) {
      *out = n;
    }
  }
  const int prows = warp_max<G>(rows);
  if (prows > 0)
    edit_pass<R, G, kRowmin, true>(t, n, p, m_cols, rows, 0, rowbuf, V, P,
                                   out, live);
  for (int p0 = G * R; p0 < prows; p0 += G * R)
    edit_pass<R, G, kRowmin, false>(t, n, p, m_cols, rows, p0, rowbuf, V, P,
                                    out, live);
}

// The problem of this lane's group; false past the batch.
template <int G>
__device__ __forceinline__ bool problem(int batch, int* b) {
  *b = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  return *b < batch;
}

template <int R, int G>
__global__ void __launch_bounds__(32 * kWarps)
    rowmin_kernel(const int8_t* __restrict__ seq1, int n_cols,
                  const int8_t* __restrict__ seq2, int m_cols,
                  const int32_t* __restrict__ len1,
                  const int32_t* __restrict__ len2, int32_t* rowbuf,
                  int32_t* __restrict__ vals, int32_t* __restrict__ pos,
                  int batch, int max_rows) {
  // the warp's first problem: the same on every lane
  if ((blockIdx.x * blockDim.x + (threadIdx.x & ~31u)) / G >= batch) return;
  int b;
  const bool live = problem<G>(batch, &b);
  const size_t c = live ? b : 0;
  const int n = live ? min(max(len1[c], 0), n_cols) : 0;
  const int rows = live ? min(max(len2[c], 0), max_rows) : 0;
  edit_sweep<R, G, true>(seq1 + c * n_cols, n, seq2 + c * m_cols, m_cols,
                         rows, rowbuf + c * (n_cols + 1),
                         vals + c * (max_rows + 1), pos + c * (max_rows + 1),
                         nullptr, live);
}

template <int R, int G>
__global__ void __launch_bounds__(32 * kWarps)
    edit_score_kernel(const int8_t* __restrict__ seq1, int n_cols,
                      const int8_t* __restrict__ seq2, int m_cols,
                      const int32_t* __restrict__ len1,
                      const int32_t* __restrict__ len2, int32_t* rowbuf,
                      int32_t* __restrict__ out, int batch, int max_rows) {
  if ((blockIdx.x * blockDim.x + (threadIdx.x & ~31u)) / G >= batch) return;
  int b;
  const bool live = problem<G>(batch, &b);
  const size_t c = live ? b : 0;
  const int n = live ? min(max(len1[c], 0), n_cols) : 0;
  const int rows = live ? min(max(len2[c], 0), max_rows) : 0;
  edit_sweep<R, G, false>(seq1 + c * n_cols, n, seq2 + c * m_cols, m_cols,
                          rows, rowbuf + c * (n_cols + 1), nullptr, nullptr,
                          out + c, live);
}

template <int R, int G>
int launch(bool rowmin, const void* seq1, int n_cols, const void* seq2,
           int m_cols, const void* len1, const void* len2, void* rowbuf,
           void* vals, void* pos, int batch, int max_rows, void* stream) {
  constexpr int kPerBlock = 32 * kWarps / G;  // problems a block
  const int blocks = (batch + kPerBlock - 1) / kPerBlock;
  const auto s1 = static_cast<const int8_t*>(seq1);
  const auto s2 = static_cast<const int8_t*>(seq2);
  const auto l1 = static_cast<const int32_t*>(len1);
  const auto l2 = static_cast<const int32_t*>(len2);
  const auto rb = static_cast<int32_t*>(rowbuf);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rowmin)
    rowmin_kernel<R, G><<<blocks, 32 * kWarps, 0, st>>>(
        s1, n_cols, s2, m_cols, l1, l2, rb, static_cast<int32_t*>(vals),
        static_cast<int32_t*>(pos), batch, max_rows);
  else
    edit_score_kernel<R, G><<<blocks, 32 * kWarps, 0, st>>>(
        s1, n_cols, s2, m_cols, l1, l2, rb, static_cast<int32_t*>(vals),
        batch, max_rows);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool rowmin, const void* seq1, int n_cols, const void* seq2,
             int m_cols, const void* len1, const void* len2, void* rowbuf,
             void* vals, void* pos, int batch, int max_rows, int rows,
             int lanes, void* stream) {
  if (batch <= 0) return 0;
  if (n_cols < 1 || m_cols < 1 || max_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define PINTRON_EDIT_LAYOUT(R, G)                                          \
  if (rows == R && lanes == G)                                             \
    return launch<R, G>(rowmin, seq1, n_cols, seq2, m_cols, len1, len2,    \
                        rowbuf, vals, pos, batch, max_rows, stream);
  PINTRON_EDIT_LAYOUT(1, 16)
  PINTRON_EDIT_LAYOUT(2, 32)
  PINTRON_EDIT_LAYOUT(16, 32)
#undef PINTRON_EDIT_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a device
// pointer allocated by the caller: seq1 (B, n_cols) and seq2 (B, m_cols)
// int8, len1/len2 (B,) int32, rowbuf (B, n_cols + 1) int32, read and
// written only when max_rows > rows * lanes (several passes); rowmin's
// vals/pos (B, max_rows + 1) int32, edit_score's out (B,) int32.  rows
// and lanes are the layout (R, G): (1, 16), (2, 32) or (16, 32).  The launch goes on the caller's stream and is not
// synchronised.  Returns the cudaError of the launch (0 on success).
extern "C" int pintron_rowmin(const void* seq1, int n_cols, const void* seq2,
                              int m_cols, const void* len1, const void* len2,
                              void* rowbuf, void* vals, void* pos, int batch,
                              int max_rows, int rows, int lanes,
                              void* stream) {
  return dispatch(true, seq1, n_cols, seq2, m_cols, len1, len2, rowbuf, vals,
                  pos, batch, max_rows, rows, lanes, stream);
}

extern "C" int pintron_edit_score(const void* seq1, int n_cols,
                                  const void* seq2, int m_cols,
                                  const void* len1, const void* len2,
                                  void* rowbuf, void* out, int batch,
                                  int max_rows, int rows, int lanes,
                                  void* stream) {
  return dispatch(false, seq1, n_cols, seq2, m_cols, len1, len2, rowbuf, out,
                  nullptr, batch, max_rows, rows, lanes, stream);
}
