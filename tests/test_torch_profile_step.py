"""`training/profile_step.py` files each kernel of the port under its
family, on the CPU: every `__global__` kernel of `csrc/*.cu` named flash_*
lands in "flash K1/K2/K3" (both routes of K1, K2 and K3) and every gn_silu_*
kernel in "GroupNorm K4/K5", by its bare name and as the profiler prints it
(namespace, template arguments, parameter list)."""

import glob
import os
import re

import pytest

from text_to_video_finetuning_tpu_torch.ops import kernel_build
from text_to_video_finetuning_tpu_torch.training.profile_step import family

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")


def _kernel_names():
    names = []
    for path in sorted(glob.glob(os.path.join(kernel_build.CSRC_DIR,
                                              "*.cu"))):
        with open(path) as f:
            names += _GLOBAL.findall(f.read())
    return names


KERNELS = _kernel_names()
FAMILY_OF = {"flash_": "flash K1/K2/K3", "gn_silu_": "GroupNorm K4/K5"}


def test_every_kernel_source_is_parsed():
    assert {"flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
            "flash_fwd_sm90_kernel", "flash_dkv_sm90_kernel",
            "flash_dq_sm90_kernel", "gn_silu_fwd_kernel",
            "gn_silu_bwd_kernel", "gn_silu_fwd_sm90_kernel",
            "gn_silu_bwd_sm90_kernel"} <= set(KERNELS)
    assert all(name.startswith(tuple(FAMILY_OF)) for name in KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_lands_in_its_family(name):
    want = next(f for prefix, f in FAMILY_OF.items()
                if name.startswith(prefix))
    assert family(name) == want
    printed = (f"void (anonymous namespace)::{name}<__nv_bfloat16>("
               "(anonymous namespace)::Params)")
    assert family(printed) == want


# ATen's kernels as torch.profiler printed them in a traced headline step on
# an H100 (the library GroupNorm sites: transformer, temporal conv,
# conv_norm_out; the elementwise ones cut after their distinguishing part)
ATEN_NORMALIZATION = [
    "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel"
    "<c10::BFloat16>(long, c10::BFloat16, c10::BFloat16 const*, "
    "c10::BFloat16*, c10::BFloat16*)",
    "void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel"
    "<c10::BFloat16>(long, long, long, c10::BFloat16 const*, c10::BFloat16 "
    "const*, c10::BFloat16 const*, c10::BFloat16 const*, "
    "at::AccumulateType<c10::BFloat16, true>::type*, "
    "at::AccumulateType<c10::BFloat16, true>::type*)",
    "void at::native::(anonymous namespace)::"
    "ComputeInternalGradientsCUDAKernel<c10::BFloat16>(long, c10::BFloat16 "
    "const*, c10::BFloat16 const*, at::AccumulateType<c10::BFloat16, "
    "true>::type*, at::AccumulateType<c10::BFloat16, true>::type*)",
    "void at::native::(anonymous namespace)::"
    "ComputeBackwardFusedParamsCUDAKernel<c10::BFloat16>(long, long, long, "
    "c10::BFloat16 const*, c10::BFloat16 const*, c10::BFloat16 const*, "
    "at::AccumulateType<c10::BFloat16, true>::type const*, "
    "at::AccumulateType<c10::BFloat16, true>::type const*, "
    "at::AccumulateType<c10::BFloat16, true>::type*, "
    "at::AccumulateType<c10::BFloat16, true>::type*)",
    "void at::native::elementwise_kernel<128, 4, at::native::"
    "gpu_kernel_impl_nocast<at::native::(anonymous namespace)::"
    "GroupNormKernelImplInternal<c10::BFloat16>(at::Tensor const&, "
    "at::Tensor const&, at::Tensor const&, long, long, long, long, "
    "c10::BFloat16, at::Tensor&, at::Tensor&, at::Tensor&)::"
    "{lambda(c10::BFloat16, float, float)#1}>",
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::(anonymous namespace)::"
    "GroupNormBackwardKernelImplInternal<c10::BFloat16>(at::Tensor const&, "
    "at::Tensor const&, at::Tensor const&, at::Tensor const&, at::Tensor "
    "const&, long, long, long, long, at::Tensor&, at::Tensor&, "
    "at::Tensor&)::{lambda(c10::BFloat16, c10::BFloat16)#1}>",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<c10::BFloat16, float, false>(int, float, c10::BFloat16 const*, "
    "c10::BFloat16 const*, c10::BFloat16 const*, float*, float*, "
    "c10::BFloat16*)",
]
# elsewhere: the random-normal draw is not a normalization; cuDNN's layout
# transposes and implicit-GEMM convolutions stay convolutions; a kernel that
# converts stays a copy / cast (none was traced: a bare name)
ATEN_ELSEWHERE = [
    ("void at::native::(anonymous namespace)::"
     "distribution_elementwise_grid_stride_kernel<float, 4, at::native::"
     "templates::cuda::normal_and_transform<float, float, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::normal_kernel"
     "<at::CUDAGeneratorImpl*>(at::TensorBase const&, double, double, "
     "at::CUDAGeneratorImpl*)", "elementwise"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>("
     "cudnn::engines_precompiled::nchw2nhwc_params_t<float>, __nv_bfloat16 "
     "const*, __nv_bfloat16*)", "convolution"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
     "5x_cudnn", "convolution"),
    ("convert_bf16_to_f32_kernel", "copy / cast"),
]


@pytest.mark.parametrize("name", ATEN_NORMALIZATION,
                         ids=lambda n: n.split("(anonymous namespace)::")[-1]
                         .split("<")[0])
def test_aten_group_norm_lands_in_normalization(name):
    assert family(name) == "normalization"


@pytest.mark.parametrize("name,want", ATEN_ELSEWHERE,
                         ids=["normal_draw", "cudnn_nchw_to_nhwc",
                              "cudnn_fprop", "convert"])
def test_other_aten_kernels_keep_their_family(name, want):
    assert family(name) == want
