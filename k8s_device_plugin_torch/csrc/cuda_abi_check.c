/*
 * Holds cuda_driver_abi.h equal to the CUDA toolkit's <cuda.h>: compiled
 * (never linked) by chip_smoke.py's build phase, where the toolkit is
 * installed, with
 *     cc -std=gnu11 -fsyntax-only -I<toolkit>/include cuda_abi_check.c
 * Every declared type, enum value, struct field and prototype becomes a
 * static assertion; a header that drifted from the driver fails to build.
 */

#include <cuda.h>

#define VTPU_CUDA_ABI_CHECK
#include "cuda_driver_abi.h"
