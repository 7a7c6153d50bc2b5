// The paired fused kernels (JAX's pair_dots=True: _make_kernel_paired,
// _make_multistep_kernel_family_paired, _make_multistep_kernel_burnin_paired;
// fused_body.cuh holds the body and its design notes): Box-Muller normals
// and windows keyed as the unpaired kernels', and under bf16 state the
// matrix slabs' momentum rounded once per launch.  State resident in shared
// memory only.

#define FUSED_STEP_VARIANT 2  // kPairedBm
#include "fused_body.cuh"

extern "C" {

#if FUSED_PART_HAS(0)
const char* fused_step_paired_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B1-pair, B2-pair, B3-pair (one step: its one rounding is the unpaired
// kernel's), B5-sgld-pair, B5-psgld-pair, B5-sgnht-pair, B5-rsghmc-pair and
// B6-pair.
FUSED_STEP_ENTRY(fused_bnn_multistep_paired_launch, kSghmc, false, false)
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_paired_launch, kSghmc, true,
                 false)
FUSED_STEP_ENTRY(fused_bnn_step_paired_launch, kSghmc, false, true)
#endif

#if FUSED_PART_HAS(1)
FUSED_STEP_ENTRY(fused_bnn_multistep_sgld_paired_launch, kSgld, false, false)
FUSED_STEP_ENTRY(fused_bnn_multistep_burnin_sgld_paired_launch, kSgld, true,
                 false)
FUSED_STEP_ENTRY(fused_bnn_multistep_psgld_paired_launch, kPsgld, false,
                 false)
#endif

#if FUSED_PART_HAS(2)
FUSED_STEP_ENTRY(fused_bnn_multistep_sgnht_paired_launch, kSgnht, false,
                 false)
FUSED_STEP_ENTRY(fused_bnn_multistep_rsghmc_paired_launch, kRsghmc, false,
                 false)
#endif

}  // extern "C"
