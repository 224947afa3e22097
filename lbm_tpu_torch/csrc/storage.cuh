// Storage type and compute type of the LBM kernels (B1-B7). A lattice lies in
// device memory as float, double or bfloat16 (the storage type S); every step
// runs in the compute type Compute<S>::type: float for bfloat16, else S
// itself. A bfloat16 kernel loads its region, runs its K steps in float and
// rounds to bfloat16 once, at the store of the pass, as the TPU kernels do
// (lbm_tpu/ops/d2q9_pallas.py computes in float32 and stores
// `state.astype(out_ref.dtype)`). The Sum|u| partials are of the compute type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace storage {

template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};

// a stored value in the compute type
__device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ double load(double v) { return v; }

// a computed value into storage: bfloat16 rounds to nearest even
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(double& d, double v) { d = v; }

}  // namespace storage
