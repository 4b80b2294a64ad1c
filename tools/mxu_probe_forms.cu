// B8's phases apart (tools/mxu_forms.py): csrc/mont_mxu.cu's tile loop
// with only the products' T = a * b, with only the reduction (on whatever
// the slice holds), or with neither (the loads and stores alone). Their
// times split the kernel's; their outputs are not results. Not part of the
// program.

#include "mont_mxu.cu"

namespace {

template <bool Products, bool Reduce>
__global__ void __launch_bounds__(32 * kWarps, 2)
    probe_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, int64_t n,
                 uint4* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  build_table(sh.table);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  TileSlice& s = sh.slice[threadIdx.x >> 5];
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t base = tile * kTileRows;
    load_tile(s, a, b, n, base, lane);
    if (Products) tile_products(s, lane);
    if (Reduce) tile_reduce(s, sh.table, lane);
    store_tile(s, out, n, base, lane);
  }
}

template <bool Products, bool Reduce>
int launch(const void* a, const void* b, int64_t n, void* out, void* stream) {
  auto kernel = probe_kernel<Products, Reduce>;
  kernel<<<static_cast<unsigned>(grid_blocks(kernel, n)), 32 * kWarps, sizeof(Shared),
           static_cast<cudaStream_t>(stream)>>>(static_cast<const uint4*>(a),
                                                static_cast<const uint4*>(b), n,
                                                static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form 0: the products alone; 1: the reduction alone; 2: loads and stores
extern "C" int mont_mxu_probe_launch(const void* a, const void* b, int64_t n, void* out, int form,
                                     void* stream) {
  if (n <= 0 || n > (int64_t{1} << 32)) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) return launch<true, false>(a, b, n, out, stream);
  if (form == 1) return launch<false, true>(a, b, n, out, stream);
  return launch<false, false>(a, b, n, out, stream);
}
