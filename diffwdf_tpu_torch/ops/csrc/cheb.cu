// Fused LPF diode clipper with a distilled piecewise-Chebyshev root, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of diffwdf_tpu/ops/fused_clipper.py:
//   cheb_kernel  <- fused_clipper_cheb / _cheb_kernel + _cheb_eval
//
// Per sample and stream (the clipper Vs(R) || C, one capacitor state z):
//   b_temp = -p1R (z - v),  a = z + b_temp,  b = cheb_root(a),
//   z' = b + b_temp,        out = (z' + z) / 2.
//
// Design.  As the other clipper kernels: one thread per stream walking all T
// samples, z in a register.  The TPU kernel baked the root's segment edges and
// coefficients into its body as immediates; here they are one small runtime
// array (a_max, three edge terms per segment, each segment's coefficients
// zero-padded to a compiled degree: 85 floats for the default degrees
// 24/16/12), staged once into shared memory, where the lanes of a warp read
// one address per segment present.  Padding makes every lane run the same
// Clenshaw steps, unrolled at the compiled degree (one kernel per degree of
// CHEB_DEGREES), so the loop neither diverges nor waits on its loads
// (cheb.cuh).  (B, T) is staged through shared memory in (128, 32) tiles
// (tile.cuh), so every global load and store is a whole 128-byte line.
//
// What bounds it.  Per sample a chain of 24 dependent Clenshaw steps (an FMA
// and an add each) at the default degrees, a division and the clips, no
// transcendentals, against 8
// bytes of traffic: one stream's chain of samples, not bytes, sets the time
// at B = 8192 (64 blocks on 132 SMs).
//
// Numerics: IEEE division, no fast-math.  Interface: plain C, loaded with
// ctypes; the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "cheb.cuh"
#include "tile.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kTileRows)
cheb_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
            float* __restrict__ out, float* __restrict__ zf, int B, int T,
            const float* __restrict__ root, int n_root, int n_seg, float p1R) {
  extern __shared__ float sroot[];
  __shared__ Tile tile;
  for (int i = threadIdx.x; i < n_root; i += blockDim.x) sroot[i] = root[i];

  const int b0 = blockIdx.x * kTileRows;
  const int b = b0 + threadIdx.x;
  float z = b < B ? z0[b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {
    const int tc = min(kTileCols, T - t0);
    tile_load(tile, vin, B, T, b0, t0, tc);  // its barrier also covers sroot
    for (int k = 0; k < tc; ++k) {
      const float b_temp = -p1R * (z - tile[threadIdx.x][k]);
      const float a = z + b_temp;
      const float z_new = cheb_root<D>(a, sroot, n_seg) + b_temp;
      tile[threadIdx.x][k] = 0.5f * (z_new + z);
      z = z_new;
    }
    tile_store(tile, out, B, T, b0, t0, tc);
  }
  if (b < B) zf[b] = z;
}

template <int D>
cudaError_t launch_cheb(const float* vin, const float* z0, float* out, float* zf, int B, int T,
                        const float* root, int n_root, int n_seg, float p1R,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_root);
  const int blocks = (B + kTileRows - 1) / kTileRows;
  cheb_kernel<D><<<blocks, kTileRows, smem, stream>>>(vin, z0, out, zf, B, T, root, n_root,
                                                      n_seg, p1R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_clipper_cheb_launch(const float* vin, const float* z0, float* out, float* zf, int B,
                              int T, const float* root, int n_root, int n_seg, int degree,
                              float p1R, void* stream) {
  if (n_seg < 1 || n_seg > kMaxChebSegments || n_root != 1 + n_seg * (degree + 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 8: return static_cast<int>(launch_cheb<8>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    case 16: return static_cast<int>(launch_cheb<16>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    case 24: return static_cast<int>(launch_cheb<24>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    case 32: return static_cast<int>(launch_cheb<32>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    case 48: return static_cast<int>(launch_cheb<48>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    case 64: return static_cast<int>(launch_cheb<64>(vin, z0, out, zf, B, T, root, n_root, n_seg, p1R, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
