// Coalesced staging of (B, T) row-major streams through shared memory, for
// kernels that give each thread one stream (row) and walk it over time.
//
// A block of kTileRows threads owns rows b0 .. b0 + kTileRows - 1.  Per time
// chunk of kTileCols samples the block copies the (kTileRows, kTileCols) tile
// in with consecutive threads on consecutive addresses of one row (a warp
// reads 32 consecutive floats: one 128-byte line), each thread then walks its
// own row of the tile, and the tile goes back out the same way.  The row
// pitch kTileCols + 1 puts the 32 rows a warp walks on 32 different banks.
// Rows past B and samples past T are masked (loaded as 0, never stored).

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

}  // namespace
