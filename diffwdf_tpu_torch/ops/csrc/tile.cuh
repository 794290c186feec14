// Coalesced staging of (B, T) row-major streams through shared memory, for
// kernels that give each stream (row) one thread, or a group of lanes, and
// walk it over time.
//
// A block of kTileRows threads owns rows b0 .. b0 + kTileRows - 1.  Per time
// chunk of kTileCols samples the block copies the (kTileRows, kTileCols) tile
// in with consecutive threads on consecutive addresses of one row (a warp
// reads 32 consecutive floats: one 128-byte line), each thread then walks its
// own row of the tile, and the tile goes back out the same way.  The row
// pitch kTileCols + 1 puts the 32 rows a warp walks on 32 different banks.
// Rows past B and samples past T are masked (loaded as 0, never stored).
// RowTile below does the same for R streams a block.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;  // threads per block, one stream each
constexpr int kTileCols = 32;   // samples per staged chunk

using Tile = float[kTileRows][kTileCols + 1];

__device__ __forceinline__ void tile_load(Tile& tile, const float* __restrict__ src, int B, int T,
                                          int b0, int t0, int tc) {
  for (int i = threadIdx.x; i < kTileRows * kTileCols; i += kTileRows) {
    const int r = i / kTileCols, c = i % kTileCols;
    const int row = b0 + r;
    tile[r][c] = (row < B && c < tc) ? src[static_cast<size_t>(row) * T + t0 + c] : 0.f;
  }
  __syncthreads();
}

__device__ __forceinline__ void tile_store(const Tile& tile, float* __restrict__ dst, int B, int T,
                                           int b0, int t0, int tc) {
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows * kTileCols; i += kTileRows) {
    const int r = i / kTileCols, c = i % kTileCols;
    const int row = b0 + r;
    if (row < B && c < tc) dst[static_cast<size_t>(row) * T + t0 + c] = tile[r][c];
  }
  __syncthreads();
}

// (R, kTileCols) tiles of R streams, for kernels that give each stream a
// group of K lanes (R = kThreads / K for a block of kThreads threads), staged
// like the (128, kTileCols) ones above by all the block's threads: a warp
// moves one 128-byte line of one stream at a time.  Rows past B and samples
// past T are masked.
//
// Where a thread moves 8 or more floats of a tile (K <= 4 at 128 threads:
// the diode pair's and the distilled root's lane kernels), it issues its
// loads in batches of 8 before their shared-memory stores, so a tile waits
// on one global latency a batch, not on one a load: in the SASS of the
// rolled loop each store waited on its load, and a tile of 64 streams
// waited on 16 global latencies in turn.  Fewer floats a thread (the NxH
// lane kernels, K >= 8) keep the rolled loop: there the batches took more
// registers than the lanes can spare (the Tube Screamer 2x16's K = 8 kernel
// went past 128 and lost a block an SM).
template <int R>
using RowTile = float[R][kTileCols + 1];

template <int R, int kThreads = kTileRows>
__device__ __forceinline__ void rows_load(RowTile<R>& tile, const float* __restrict__ src, int B,
                                          int T, int b0, int t0, int tc) {
  static_assert(R * kTileCols % kThreads == 0, "a whole number of loads a thread");
  constexpr int kPer = R * kTileCols / kThreads;
  if constexpr (kPer >= 8) {
    static_assert(kPer % 8 == 0, "whole batches of loads");
    // the batches in a rolled loop: unrolled, ptxas kept every batch's row
    // pointers live across the time loop (B2's run-time-count kernel spilled)
#pragma unroll 1
    for (int j0 = 0; j0 < kPer; j0 += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        const int r = i / kTileCols, c = i % kTileCols;
        const int row = b0 + r;
        x[j] = (row < B && c < tc) ? src[static_cast<size_t>(row) * T + t0 + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        tile[i / kTileCols][i % kTileCols] = x[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * kTileCols; i += blockDim.x) {
      const int r = i / kTileCols, c = i % kTileCols;
      const int row = b0 + r;
      tile[r][c] = (row < B && c < tc) ? src[static_cast<size_t>(row) * T + t0 + c] : 0.f;
    }
  }
  __syncthreads();
}

template <int R, int kThreads = kTileRows>
__device__ __forceinline__ void rows_store(const RowTile<R>& tile, float* __restrict__ dst, int B,
                                           int T, int b0, int t0, int tc) {
  static_assert(R * kTileCols % kThreads == 0, "a whole number of stores a thread");
  constexpr int kPer = R * kTileCols / kThreads;
  __syncthreads();
  if constexpr (kPer >= 8) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kTileCols, c = i % kTileCols;
      const int row = b0 + r;
      if (row < B && c < tc) dst[static_cast<size_t>(row) * T + t0 + c] = tile[r][c];
    }
  } else {
    for (int i = threadIdx.x; i < R * kTileCols; i += blockDim.x) {
      const int r = i / kTileCols, c = i % kTileCols;
      const int row = b0 + r;
      if (row < B && c < tc) dst[static_cast<size_t>(row) * T + t0 + c] = tile[r][c];
    }
  }
  __syncthreads();
}

}  // namespace
