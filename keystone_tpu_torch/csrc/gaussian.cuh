// The Gaussian kernel's epilogue, shared by gaussian_kernel_block.cu and
// gaussian_resid_block.cu: one entry of K from the squared row norms xn and
// yn and the cross term dot = x . y. It keeps the reference's clamp
// max(sq, 0) exactly: on a diagonal block rounding leaves sq slightly
// negative or positive near 0, and the Cholesky of K_bb + lambda I needs the
// diagonal at 1.

#pragma once

namespace kt_pipe {

__device__ __forceinline__ float gauss(float xn, float yn, float dot, float gamma) {
  const float sq = xn + yn - 2.0f * dot;
  return expf(-gamma * fmaxf(sq, 0.0f));
}

}  // namespace kt_pipe
