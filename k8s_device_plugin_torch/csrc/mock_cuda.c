/*
 * A CUDA driver test double (mock_libtpu.c's role for libvtpu.so): the
 * CPU tests interpose libvtpu_cuda.so in front of it with
 * VTPU_REAL_CUDA_LIBRARY pointing here.
 *
 * It exports the driver entry points of cuda_driver_abi.h, with the real
 * driver's lookup: cuGetProcAddress(_v2) answers a base name for a CUDA
 * version and stream flag with the matching versioned or `_ptsz` entry
 * point, from its own table (never through dlsym, as the real driver).
 * Each entry point is a static function exported under its name as an
 * alias, so the addresses the table hands out cannot be interposed.
 *
 * The devices hold no memory: an allocation gets an address and counts
 * against the device's size, and a launch advances a virtual device clock
 * by its device time, which events read. Settings, read at first use:
 *   VTPU_MOCK_CUDA_DEVICES    devices (default 1, at most 8)
 *   VTPU_MOCK_CUDA_HBM        bytes a device holds (default 80 GiB)
 *   VTPU_MOCK_CUDA_CTX_BYTES  bytes a context reserves (default 0)
 *   VTPU_MOCK_CUDA_LAUNCH_US  device time of a kernel launch per block of
 *                             its grid (default 0)
 *   VTPU_MOCK_CUDA_GRAPH_US   device time of a graph launch (default 0)
 * vtpu_mock_cuda_counters() reads what it saw (see its comment).
 */

#define _GNU_SOURCE
#include "cuda_driver_abi.h"

#include <pthread.h>
#include <stdlib.h>
#include <string.h>

#define MAX_DEVS 8
#define MAX_STACK 16

typedef struct mock_ctx {
    int dev;
    int refs; /* primary: retains; created: 1 */
} mock_ctx_t;

typedef struct {
    uint64_t key;
    uint64_t bytes;
    int dev;
} mock_alloc_t;

static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_once_t g_once = PTHREAD_ONCE_INIT;
static int g_ndevs;
static uint64_t g_hbm, g_ctx_bytes, g_launch_us, g_graph_us;
static uint64_t g_used[MAX_DEVS];
static mock_ctx_t g_primary[MAX_DEVS];
static mock_alloc_t *g_allocs;
static size_t g_nallocs, g_cap_allocs;
static uint64_t g_next_addr = 0x7f0000000000ull, g_next_handle = 1;
static uint64_t g_clock_ns; /* the virtual device clock */
/* launches by the legacy / per-thread default-stream entry points,
 * graph launches */
static uint64_t g_launches, g_launches_ptsz, g_graph_launches;

static __thread mock_ctx_t *t_stack[MAX_STACK];
static __thread int t_depth;

static uint64_t env_u64(const char *name, uint64_t dflt) {
    const char *v = getenv(name);
    return v && *v ? strtoull(v, NULL, 10) : dflt;
}

static void configure(void) {
    g_ndevs = (int)env_u64("VTPU_MOCK_CUDA_DEVICES", 1);
    if (g_ndevs < 1 || g_ndevs > MAX_DEVS) {
        g_ndevs = 1;
    }
    g_hbm = env_u64("VTPU_MOCK_CUDA_HBM", 80ull << 30);
    g_ctx_bytes = env_u64("VTPU_MOCK_CUDA_CTX_BYTES", 0);
    g_launch_us = env_u64("VTPU_MOCK_CUDA_LAUNCH_US", 0);
    g_graph_us = env_u64("VTPU_MOCK_CUDA_GRAPH_US", 0);
    for (int i = 0; i < MAX_DEVS; i++) {
        g_primary[i].dev = i;
    }
}

#define LOCK()                                                            \
    do {                                                                  \
        pthread_once(&g_once, configure);                                 \
        pthread_mutex_lock(&g_mu);                                        \
    } while (0)
#define UNLOCK() pthread_mutex_unlock(&g_mu)

static mock_ctx_t *current(void) {
    return t_depth ? t_stack[t_depth - 1] : NULL;
}

/* ------------------------------------------------------------ contexts */

static CUresult m_cuInit(unsigned int Flags) {
    (void)Flags;
    pthread_once(&g_once, configure);
    return CUDA_SUCCESS;
}

static CUresult m_cuDevicePrimaryCtxRetain(CUcontext *pctx, CUdevice dev) {
    LOCK();
    if (dev < 0 || dev >= g_ndevs) {
        UNLOCK();
        return CUDA_ERROR_INVALID_VALUE;
    }
    if (g_primary[dev].refs++ == 0) {
        g_used[dev] += g_ctx_bytes;
    }
    *pctx = (CUcontext)&g_primary[dev];
    UNLOCK();
    return CUDA_SUCCESS;
}

static CUresult m_cuDevicePrimaryCtxRelease_v2(CUdevice dev) {
    LOCK();
    if (dev < 0 || dev >= g_ndevs || g_primary[dev].refs == 0) {
        UNLOCK();
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    if (--g_primary[dev].refs == 0) {
        g_used[dev] -= g_ctx_bytes;
    }
    UNLOCK();
    return CUDA_SUCCESS;
}

static CUresult m_cuDevicePrimaryCtxGetState(CUdevice dev,
                                             unsigned int *flags,
                                             int *active) {
    LOCK();
    if (dev < 0 || dev >= g_ndevs) {
        UNLOCK();
        return CUDA_ERROR_INVALID_VALUE;
    }
    *flags = 0;
    *active = g_primary[dev].refs > 0;
    UNLOCK();
    return CUDA_SUCCESS;
}

static CUresult m_cuCtxPushCurrent_v2(CUcontext ctx) {
    if (!ctx || t_depth == MAX_STACK) {
        return CUDA_ERROR_INVALID_VALUE;
    }
    t_stack[t_depth++] = (mock_ctx_t *)ctx;
    return CUDA_SUCCESS;
}

static CUresult m_cuCtxPopCurrent_v2(CUcontext *pctx) {
    if (!t_depth) {
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    mock_ctx_t *top = t_stack[--t_depth];
    if (pctx) {
        *pctx = (CUcontext)top;
    }
    return CUDA_SUCCESS;
}

static CUresult m_cuCtxCreate_v2(CUcontext *pctx, unsigned int flags,
                                 CUdevice dev) {
    (void)flags;
    LOCK();
    if (dev < 0 || dev >= g_ndevs) {
        UNLOCK();
        return CUDA_ERROR_INVALID_VALUE;
    }
    mock_ctx_t *ctx = calloc(1, sizeof(*ctx));
    if (!ctx) {
        UNLOCK();
        return CUDA_ERROR_OUT_OF_MEMORY;
    }
    ctx->dev = dev;
    ctx->refs = 1;
    g_used[dev] += g_ctx_bytes;
    UNLOCK();
    *pctx = (CUcontext)ctx;
    return m_cuCtxPushCurrent_v2(*pctx);
}

static CUresult m_cuCtxDestroy_v2(CUcontext ctx) {
    mock_ctx_t *c = (mock_ctx_t *)ctx;
    if (!c || (c >= g_primary && c < g_primary + MAX_DEVS)) {
        return CUDA_ERROR_INVALID_CONTEXT; /* primaries are released */
    }
    LOCK();
    g_used[c->dev] -= g_ctx_bytes;
    UNLOCK();
    if (current() == c) {
        t_depth--;
    }
    free(c);
    return CUDA_SUCCESS;
}

static CUresult m_cuCtxSetCurrent(CUcontext ctx) {
    if (!ctx) {
        if (t_depth) {
            t_depth--;
        }
        return CUDA_SUCCESS;
    }
    if (t_depth) {
        t_stack[t_depth - 1] = (mock_ctx_t *)ctx;
        return CUDA_SUCCESS;
    }
    return m_cuCtxPushCurrent_v2(ctx);
}

static CUresult m_cuCtxGetCurrent(CUcontext *pctx) {
    *pctx = (CUcontext)current();
    return CUDA_SUCCESS;
}

static CUresult m_cuCtxGetDevice(CUdevice *device) {
    mock_ctx_t *c = current();
    if (!c) {
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    *device = c->dev;
    return CUDA_SUCCESS;
}

/* -------------------------------------------------------------- memory */

/* under g_mu */
static CUresult take_bytes(int dev, uint64_t bytes, uint64_t key) {
    if (bytes == 0) {
        return CUDA_ERROR_INVALID_VALUE;
    }
    if (g_used[dev] + bytes > g_hbm) {
        return CUDA_ERROR_OUT_OF_MEMORY;
    }
    if (g_nallocs == g_cap_allocs) {
        size_t ncap = g_cap_allocs ? 2 * g_cap_allocs : 256;
        mock_alloc_t *n = realloc(g_allocs, ncap * sizeof(*n));
        if (!n) {
            return CUDA_ERROR_OUT_OF_MEMORY;
        }
        g_allocs = n;
        g_cap_allocs = ncap;
    }
    g_allocs[g_nallocs++] = (mock_alloc_t){key, bytes, dev};
    g_used[dev] += bytes;
    return CUDA_SUCCESS;
}

/* under g_mu */
static CUresult give_back(uint64_t key) {
    for (size_t i = 0; i < g_nallocs; i++) {
        if (g_allocs[i].key == key) {
            g_used[g_allocs[i].dev] -= g_allocs[i].bytes;
            g_allocs[i] = g_allocs[--g_nallocs];
            return CUDA_SUCCESS;
        }
    }
    return CUDA_ERROR_INVALID_VALUE;
}

static CUresult alloc_on_current(CUdeviceptr *dptr, uint64_t bytes) {
    mock_ctx_t *c = current();
    if (!c) {
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    LOCK();
    uint64_t addr = g_next_addr;
    CUresult rc = take_bytes(c->dev, bytes, addr);
    if (rc == CUDA_SUCCESS) {
        g_next_addr += (bytes + (2ull << 20) - 1) & ~((2ull << 20) - 1);
        *dptr = addr;
    }
    UNLOCK();
    return rc;
}

static CUresult m_cuMemAlloc_v2(CUdeviceptr *dptr, size_t bytesize) {
    return alloc_on_current(dptr, bytesize);
}

static CUresult m_cuMemAllocPitch_v2(CUdeviceptr *dptr, size_t *pPitch,
                                     size_t WidthInBytes, size_t Height,
                                     unsigned int ElementSizeBytes) {
    (void)ElementSizeBytes;
    size_t pitch = (WidthInBytes + 511) & ~(size_t)511;
    CUresult rc = alloc_on_current(dptr, (uint64_t)pitch * Height);
    if (rc == CUDA_SUCCESS) {
        *pPitch = pitch;
    }
    return rc;
}

static CUresult m_cuMemAllocAsync(CUdeviceptr *dptr, size_t bytesize,
                                  CUstream hStream) {
    (void)hStream;
    return alloc_on_current(dptr, bytesize);
}

static CUresult m_cuMemAllocFromPoolAsync(CUdeviceptr *dptr, size_t bytesize,
                                          CUmemoryPool pool,
                                          CUstream hStream) {
    (void)pool;
    (void)hStream;
    return alloc_on_current(dptr, bytesize);
}

static CUresult m_cuMemCreate(CUmemGenericAllocationHandle *handle,
                              size_t size, const CUmemAllocationProp *prop,
                              unsigned long long flags) {
    (void)flags;
    LOCK();
    int dev = prop->location.id;
    if (prop->location.type != CU_MEM_LOCATION_TYPE_DEVICE || dev < 0 ||
        dev >= g_ndevs) {
        UNLOCK();
        return CUDA_ERROR_INVALID_VALUE;
    }
    uint64_t key = g_next_handle;
    CUresult rc = take_bytes(dev, size, key);
    if (rc == CUDA_SUCCESS) {
        g_next_handle++;
        *handle = key;
    }
    UNLOCK();
    return rc;
}

static CUresult m_cuMemFree_v2(CUdeviceptr dptr) {
    LOCK();
    CUresult rc = give_back(dptr);
    UNLOCK();
    return rc;
}

static CUresult m_cuMemFreeAsync(CUdeviceptr dptr, CUstream hStream) {
    (void)hStream;
    return m_cuMemFree_v2(dptr);
}

static CUresult m_cuMemAllocAsync_ptsz(CUdeviceptr *dptr, size_t bytesize,
                                       CUstream hStream) {
    return m_cuMemAllocAsync(dptr, bytesize, hStream);
}

static CUresult m_cuMemAllocFromPoolAsync_ptsz(CUdeviceptr *dptr,
                                               size_t bytesize,
                                               CUmemoryPool pool,
                                               CUstream hStream) {
    return m_cuMemAllocFromPoolAsync(dptr, bytesize, pool, hStream);
}

static CUresult m_cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream hStream) {
    return m_cuMemFreeAsync(dptr, hStream);
}

static CUresult m_cuMemRelease(CUmemGenericAllocationHandle handle) {
    LOCK();
    CUresult rc = give_back(handle);
    UNLOCK();
    return rc;
}

static CUresult m_cuMemGetInfo_v2(size_t *free, size_t *total) {
    mock_ctx_t *c = current();
    if (!c) {
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    LOCK();
    *free = g_hbm - g_used[c->dev];
    *total = g_hbm;
    UNLOCK();
    return CUDA_SUCCESS;
}

/* ------------------------------------------------------------ launches */

static CUresult run(uint64_t us, uint64_t *counter) {
    if (!current()) {
        return CUDA_ERROR_INVALID_CONTEXT;
    }
    LOCK();
    g_clock_ns += us * 1000ull;
    (*counter)++;
    UNLOCK();
    return CUDA_SUCCESS;
}

#define GRID_US (g_launch_us * (uint64_t)gridDimX * gridDimY * gridDimZ)

static CUresult m_cuLaunchKernel(CUfunction f, VTPU_CU_LAUNCH_DIMS,
                                 CUstream hStream, void **kernelParams,
                                 void **extra) {
    (void)f, (void)blockDimX, (void)blockDimY, (void)blockDimZ;
    (void)sharedMemBytes, (void)hStream, (void)kernelParams, (void)extra;
    return run(GRID_US, &g_launches);
}

static CUresult m_cuLaunchKernel_ptsz(CUfunction f, VTPU_CU_LAUNCH_DIMS,
                                      CUstream hStream, void **kernelParams,
                                      void **extra) {
    (void)f, (void)blockDimX, (void)blockDimY, (void)blockDimZ;
    (void)sharedMemBytes, (void)hStream, (void)kernelParams, (void)extra;
    return run(GRID_US, &g_launches_ptsz);
}

static CUresult m_cuLaunchCooperativeKernel(CUfunction f, VTPU_CU_LAUNCH_DIMS,
                                            CUstream hStream,
                                            void **kernelParams) {
    return m_cuLaunchKernel(f, gridDimX, gridDimY, gridDimZ, blockDimX,
                            blockDimY, blockDimZ, sharedMemBytes, hStream,
                            kernelParams, NULL);
}

static CUresult m_cuLaunchCooperativeKernel_ptsz(
    CUfunction f, VTPU_CU_LAUNCH_DIMS, CUstream hStream,
    void **kernelParams) {
    return m_cuLaunchKernel_ptsz(f, gridDimX, gridDimY, gridDimZ, blockDimX,
                                 blockDimY, blockDimZ, sharedMemBytes,
                                 hStream, kernelParams, NULL);
}

static CUresult m_cuLaunchKernelEx(const CUlaunchConfig *config,
                                   CUfunction f, void **kernelParams,
                                   void **extra) {
    (void)kernelParams, (void)extra, (void)f;
    uint64_t blocks = (uint64_t)config->gridDimX * config->gridDimY *
                      config->gridDimZ;
    return run(g_launch_us * blocks, &g_launches);
}

static CUresult m_cuLaunchKernelEx_ptsz(const CUlaunchConfig *config,
                                        CUfunction f, void **kernelParams,
                                        void **extra) {
    (void)kernelParams, (void)extra, (void)f;
    uint64_t blocks = (uint64_t)config->gridDimX * config->gridDimY *
                      config->gridDimZ;
    return run(g_launch_us * blocks, &g_launches_ptsz);
}

static CUresult m_cuGraphLaunch(CUgraphExec hGraphExec, CUstream hStream) {
    (void)hGraphExec, (void)hStream;
    return run(g_graph_us, &g_graph_launches);
}

static CUresult m_cuGraphLaunch_ptsz(CUgraphExec hGraphExec,
                                     CUstream hStream) {
    return m_cuGraphLaunch(hGraphExec, hStream);
}

/* -------------------------------------------------------------- events */

static CUresult m_cuEventCreate(CUevent *phEvent, unsigned int Flags) {
    (void)Flags;
    uint64_t *ev = calloc(1, sizeof(*ev));
    if (!ev) {
        return CUDA_ERROR_OUT_OF_MEMORY;
    }
    *phEvent = (CUevent)ev;
    return CUDA_SUCCESS;
}

static CUresult m_cuEventDestroy_v2(CUevent hEvent) {
    free(hEvent);
    return CUDA_SUCCESS;
}

static CUresult m_cuEventRecord(CUevent hEvent, CUstream hStream) {
    (void)hStream;
    LOCK();
    *(uint64_t *)hEvent = g_clock_ns;
    UNLOCK();
    return CUDA_SUCCESS;
}

static CUresult m_cuEventQuery(CUevent hEvent) {
    (void)hEvent;
    return CUDA_SUCCESS; /* the virtual device is never behind */
}

static CUresult m_cuEventElapsedTime(float *pMilliseconds, CUevent hStart,
                                     CUevent hEnd) {
    LOCK();
    *pMilliseconds = (float)((double)(*(uint64_t *)hEnd -
                                      *(uint64_t *)hStart) / 1e6);
    UNLOCK();
    return CUDA_SUCCESS;
}

static CUresult m_cuStreamIsCapturing(CUstream hStream,
                                      CUstreamCaptureStatus *captureStatus) {
    (void)hStream;
    *captureStatus = CU_STREAM_CAPTURE_STATUS_NONE;
    return CUDA_SUCCESS;
}

/* -------------------------------------------------------------- lookup */

static CUresult m_cuGetProcAddress_v2(
    const char *symbol, void **pfn, int cudaVersion, cuuint64_t flags,
    CUdriverProcAddressQueryResult *symbolStatus);
static CUresult m_cuGetProcAddress(const char *symbol, void **pfn,
                                   int cudaVersion, cuuint64_t flags);

/* (exported name, base name, from version, before version, ptsz twin,
 * is the twin) */
#define MOCK_TABLE(X)                                                     \
    X(cuInit, "cuInit", 2000, 0, 0, 0)                                    \
    X(cuGetProcAddress, "cuGetProcAddress", 11030, 12000, 0, 0)           \
    X(cuGetProcAddress_v2, "cuGetProcAddress", 12000, 0, 0, 0)            \
    X(cuDevicePrimaryCtxRetain, "cuDevicePrimaryCtxRetain", 7000, 0, 0, 0) \
    X(cuDevicePrimaryCtxRelease_v2, "cuDevicePrimaryCtxRelease", 11000, 0, \
      0, 0)                                                               \
    X(cuDevicePrimaryCtxGetState, "cuDevicePrimaryCtxGetState", 7000, 0,  \
      0, 0)                                                               \
    X(cuCtxCreate_v2, "cuCtxCreate", 3020, 0, 0, 0)                       \
    X(cuCtxDestroy_v2, "cuCtxDestroy", 4000, 0, 0, 0)                     \
    X(cuCtxPushCurrent_v2, "cuCtxPushCurrent", 4000, 0, 0, 0)             \
    X(cuCtxPopCurrent_v2, "cuCtxPopCurrent", 4000, 0, 0, 0)               \
    X(cuCtxSetCurrent, "cuCtxSetCurrent", 4000, 0, 0, 0)                  \
    X(cuCtxGetCurrent, "cuCtxGetCurrent", 4000, 0, 0, 0)                  \
    X(cuCtxGetDevice, "cuCtxGetDevice", 2000, 0, 0, 0)                    \
    X(cuMemAlloc_v2, "cuMemAlloc", 3020, 0, 0, 0)                         \
    X(cuMemAllocPitch_v2, "cuMemAllocPitch", 3020, 0, 0, 0)               \
    X(cuMemAllocAsync, "cuMemAllocAsync", 11020, 0, 1, 0)                 \
    X(cuMemAllocAsync_ptsz, "cuMemAllocAsync", 11020, 0, 1, 1)            \
    X(cuMemAllocFromPoolAsync, "cuMemAllocFromPoolAsync", 11020, 0, 1, 0) \
    X(cuMemAllocFromPoolAsync_ptsz, "cuMemAllocFromPoolAsync", 11020, 0,  \
      1, 1)                                                               \
    X(cuMemCreate, "cuMemCreate", 10020, 0, 0, 0)                         \
    X(cuMemFree_v2, "cuMemFree", 3020, 0, 0, 0)                           \
    X(cuMemFreeAsync, "cuMemFreeAsync", 11020, 0, 1, 0)                   \
    X(cuMemFreeAsync_ptsz, "cuMemFreeAsync", 11020, 0, 1, 1)              \
    X(cuMemRelease, "cuMemRelease", 10020, 0, 0, 0)                       \
    X(cuMemGetInfo_v2, "cuMemGetInfo", 3020, 0, 0, 0)                     \
    X(cuLaunchKernel, "cuLaunchKernel", 4000, 0, 1, 0)                    \
    X(cuLaunchKernel_ptsz, "cuLaunchKernel", 4000, 0, 1, 1)               \
    X(cuLaunchKernelEx, "cuLaunchKernelEx", 11060, 0, 1, 0)               \
    X(cuLaunchKernelEx_ptsz, "cuLaunchKernelEx", 11060, 0, 1, 1)          \
    X(cuLaunchCooperativeKernel, "cuLaunchCooperativeKernel", 9000, 0, 1, \
      0)                                                                  \
    X(cuLaunchCooperativeKernel_ptsz, "cuLaunchCooperativeKernel", 9000,  \
      0, 1, 1)                                                            \
    X(cuGraphLaunch, "cuGraphLaunch", 10000, 0, 1, 0)                     \
    X(cuGraphLaunch_ptsz, "cuGraphLaunch", 10000, 0, 1, 1)                \
    X(cuEventCreate, "cuEventCreate", 2000, 0, 0, 0)                      \
    X(cuEventDestroy_v2, "cuEventDestroy", 4000, 0, 0, 0)                 \
    X(cuEventRecord, "cuEventRecord", 2000, 0, 0, 0)                      \
    X(cuEventQuery, "cuEventQuery", 2000, 0, 0, 0)                        \
    X(cuEventElapsedTime, "cuEventElapsedTime", 2000, 0, 0, 0)            \
    X(cuStreamIsCapturing, "cuStreamIsCapturing", 10000, 0, 0, 0)

static const struct {
    const char *base;
    int min_version, max_version, stream_ordered, ptsz;
    void *fn;
} g_table[] = {
#define MOCK_ROW_(name, base, lo, hi, so, pt)                             \
    {base, lo, hi, so, pt, (void *)m_##name},
    MOCK_TABLE(MOCK_ROW_)};

#define MOCK_EXPORT_(name, ...)                                           \
    __typeof__(name) name __attribute__((alias("m_" #name)));
MOCK_TABLE(MOCK_EXPORT_)

static CUresult lookup(const char *symbol, void **pfn, int version,
                       cuuint64_t flags, CUdriverProcAddressQueryResult *st) {
    int ptsz = (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) != 0;
    int known = 0;
    *pfn = NULL;
    for (size_t i = 0; i < sizeof(g_table) / sizeof(*g_table); i++) {
        if (strcmp(g_table[i].base, symbol)) {
            continue;
        }
        known = 1;
        if (version >= g_table[i].min_version &&
            (!g_table[i].max_version || version < g_table[i].max_version) &&
            (!g_table[i].stream_ordered || g_table[i].ptsz == ptsz)) {
            *pfn = g_table[i].fn;
            break;
        }
    }
    if (st) {
        *st = *pfn ? CU_GET_PROC_ADDRESS_SUCCESS
              : known ? CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT
                      : CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
    }
    return *pfn ? CUDA_SUCCESS : CUDA_ERROR_NOT_FOUND;
}

static CUresult m_cuGetProcAddress_v2(
    const char *symbol, void **pfn, int cudaVersion, cuuint64_t flags,
    CUdriverProcAddressQueryResult *symbolStatus) {
    return lookup(symbol, pfn, cudaVersion, flags, symbolStatus);
}

static CUresult m_cuGetProcAddress(const char *symbol, void **pfn,
                                   int cudaVersion, cuuint64_t flags) {
    return lookup(symbol, pfn, cudaVersion, flags, NULL);
}

/* what the mock saw: out[0] launches through the legacy-stream entry
 * points, out[1] through the `_ptsz` ones, out[2] graph launches, out[3]
 * bytes in use on device 0, out[4] live allocations */
void vtpu_mock_cuda_counters(uint64_t out[5]) {
    LOCK();
    out[0] = g_launches;
    out[1] = g_launches_ptsz;
    out[2] = g_graph_launches;
    out[3] = g_used[0];
    out[4] = g_nallocs;
    UNLOCK();
}
