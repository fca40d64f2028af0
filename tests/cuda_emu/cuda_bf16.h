// A stand-in for cuda_bf16.h (see cuda_runtime.h): bf16 as its 16 bits,
// converted with round-to-nearest-even.
#pragma once
struct __nv_bfloat16 { unsigned short v; };
float __bfloat162float(__nv_bfloat16 b);
__nv_bfloat16 __float2bfloat16(float f);
