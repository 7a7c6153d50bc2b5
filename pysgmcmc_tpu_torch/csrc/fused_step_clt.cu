// The fused kernels B1-B6 with the MXU-CLT generator (JAX's
// noise_impl="hadamard_clt"; fused_body.cuh holds the body, the generator
// and their design notes): the library of ops/fused_step.py's wrappers for
// noise_impl="hadamard_clt".  Every kernel, both placements, both storages
// of v.  The generator has no injected-noise path (noise is ignored; the
// wrappers refuse it, as JAX's do).

#define FUSED_STEP_VARIANT 1  // kClt
#include "fused_body.cuh"

extern "C" {

#if FUSED_PART_HAS(0)
const char* fused_step_clt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

FUSED_STEP_ENTRY(fused_bnn_multistep_clt_launch, kSghmc, false, false)
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_clt_launch, kSghmc, true, false)
FUSED_STEP_ENTRY(fused_bnn_step_clt_launch, kSghmc, false, true)
#endif

#if FUSED_PART_HAS(1)
FUSED_STEP_ENTRY(fused_bnn_step_sgld_clt_launch, kSgld, false, true)
FUSED_STEP_ENTRY(fused_bnn_multistep_sgld_clt_launch, kSgld, false, false)
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_sgld_clt_launch, kSgld, true,
                 false)
FUSED_STEP_ENTRY(fused_bnn_step_psgld_clt_launch, kPsgld, false, true)
FUSED_STEP_ENTRY(fused_bnn_multistep_psgld_clt_launch, kPsgld, false, false)
#endif

#if FUSED_PART_HAS(2)
FUSED_STEP_ENTRY(fused_bnn_step_sgnht_clt_launch, kSgnht, false, true)
FUSED_STEP_ENTRY(fused_bnn_step_rsghmc_clt_launch, kRsghmc, false, true)
FUSED_STEP_ENTRY(fused_bnn_multistep_sgnht_clt_launch, kSgnht, false, false)
FUSED_STEP_ENTRY(fused_bnn_multistep_rsghmc_clt_launch, kRsghmc, false,
                 false)
#endif

}  // extern "C"
