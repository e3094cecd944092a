/*
 * libvtpu_cuda.so — the port's in-container enforcement shim: the CUDA
 * driver API counterpart of lib/tpu/vtpu_preload.c (libvtpu.so), which
 * wraps the PJRT C API. Loaded with LD_PRELOAD into the tenant's own
 * process, it enforces the same VTPU_* contract and writes the same shared
 * region (vtpu_shm.h) that the node monitor reads:
 *
 *   cuMemAlloc_v2, cuMemAllocPitch_v2,  hard device-memory cap: OOM at
 *   cuMemAllocAsync, cuMemAllocFrom-    allocation time (the counterparts
 *   PoolAsync, cuMemCreate              of BufferFromHostBuffer & co.)
 *   cuMemFree_v2, cuMemFreeAsync,       release accounting (a pointer ->
 *   cuMemRelease                        (bytes, ordinal) table)
 *   cuDevicePrimaryCtxRetain /          the context's footprint, charged
 *   cuDevicePrimaryCtxRelease_v2        once per primary context
 *   cuLaunchKernel, cuLaunchKernelEx,   duty-cycle token bucket, charged a
 *   cuLaunchCooperativeKernel,          measured cost per CUfunction (or
 *   cuGraphLaunch                       graph), as Execute is per program
 *   cuMemGetInfo_v2                     total = the cap, free = cap - used
 *   cuModuleLoad, cuModuleLoadData,     loaded device code: the image's
 *   cuModuleLoadDataEx, cuModuleLoad-   code for the device's SM charged
 *   FatBinary, cuLibraryLoadData,       as module memory (the counterpart
 *   cuLibraryLoadFromFile               of Compile/DeserializeAndLoad's
 *                                       SizeOfGeneratedCodeInBytes),
 *                                       refused past the cap
 *   cuModuleUnload, cuLibraryUnload     the charge released
 *
 * Reaching the calls. The CUDA runtime (PyTorch's libcudart, or the
 * static cudart inside each kernel library nvcc builds) dlopens
 * libcuda.so.1, takes cuGetProcAddress(_v2) from it with dlsym, and every
 * other entry point through that; a library may also dlsym an entry point
 * itself (PyTorch's driver API table), or link the driver directly. So
 * the shim interposes dlsym (the real one comes from dlvsym(RTLD_NEXT))
 * and answers with its own function for the hooked names, its
 * cuGetProcAddress(_v2) returns its own function wherever the driver's
 * answer for that name, version and stream flag is a hooked entry point,
 * and it exports every hooked name for a direct call. Each hook forwards
 * to the entry point of the real driver, VTPU_REAL_CUDA_LIBRARY (default
 * libcuda.so.1), which the shim dlopens at first use. Everything else,
 * cuGetExportTable and cuTensorMapEncodeTiled included, passes through
 * untouched.
 *
 * Fail-open rules, as libvtpu.so's: the kill switch
 * VTPU_DISABLE_CONTROL=true, or no VTPU_DEVICE_MEMORY_SHARED_CACHE, and
 * no hook accounts or throttles anything (each forwards as it is).
 */

#define _GNU_SOURCE
#include "cuda_driver_abi.h"
#include "vtpu_image.h"
#include "vtpu_shm.h"

#include <dlfcn.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>


/* ---------------------------------------------------------------- state */

static vtpu_shared_region_t *g_region = NULL;
static int g_slot = -1;
static int g_disabled = 0;
static int g_debug = 0; /* VTPU_DEBUG=1: per-hook stderr trace */
static int g_core_policy_off = 0; /* VTPU_CORE_UTILIZATION_POLICY=disable */
static uint64_t g_exec_cost_us = 2000; /* cost before any launch is timed */
static int g_exec_cost_fixed = 0; /* VTPU_EXEC_COST_US set: no EMA */
static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;

#define VTPU_DBG(...)                                                     \
    do {                                                                  \
        if (g_debug) {                                                    \
            fprintf(stderr, "vtpu-dbg: " __VA_ARGS__);                    \
            fputc('\n', stderr);                                          \
        }                                                                 \
    } while (0)

static int env_is_true(const char *name) {
    const char *v = getenv(name);
    return v && (!strcmp(v, "true") || !strcmp(v, "1") || !strcmp(v, "on"));
}

static uint64_t now_mono_us(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000ull + (uint64_t)ts.tv_nsec / 1000ull;
}

static int accounting(int dev) {
    return g_region && g_slot >= 0 && dev >= 0 && dev < VTPU_MAX_DEVICES;
}

/* ------------------------------------------------- the real driver */

typedef void *(*dlsym_fn)(void *, const char *);

static dlsym_fn real_dlsym(void) {
    static dlsym_fn fn;
    if (!fn) {
        /* glibc >= 2.34 keeps dlsym in libc.so.6 at GLIBC_2.34; older
         * ones (and the compat alias) at the architecture's base version */
        static const char *const versions[] = {"GLIBC_2.34", "GLIBC_2.2.5",
                                               "GLIBC_2.17"};
        for (size_t i = 0; !fn && i < sizeof(versions) / sizeof(*versions);
             i++) {
            fn = (dlsym_fn)dlvsym(RTLD_NEXT, "dlsym", versions[i]);
        }
    }
    return fn;
}

static void *g_real_lib = NULL;
static pthread_once_t g_real_once = PTHREAD_ONCE_INIT;

static void load_real(void) {
    const char *path = getenv("VTPU_REAL_CUDA_LIBRARY");
    if (!path) {
        path = "libcuda.so.1";
    }
    g_real_lib = dlopen(path, RTLD_NOW | RTLD_LOCAL);
    if (!g_real_lib) {
        fprintf(stderr, "vtpu: cannot load the real CUDA driver %s: %s\n",
                path, dlerror());
    }
}

/* the real driver's `name`, or NULL */
static void *real_symbol(const char *name) {
    pthread_once(&g_real_once, load_real);
    dlsym_fn sym = real_dlsym();
    return g_real_lib && sym ? sym(g_real_lib, name) : NULL;
}

/* driver entry points the shim calls itself and does not hook */
#define DRIVER_CALLS(X)                                                   \
    X(cuDevicePrimaryCtxGetState)                                         \
    X(cuCtxCreate_v2)                                                     \
    X(cuCtxDestroy_v2)                                                    \
    X(cuCtxGetDevice)                                                     \
    X(cuDeviceGetAttribute)                                               \
    X(cuEventCreate)                                                      \
    X(cuEventRecord)                                                      \
    X(cuEventQuery)                                                       \
    X(cuEventElapsedTime)                                                 \
    X(cuStreamIsCapturing)

#define DRIVER_SLOT_(name) __typeof__(&name) name;
static struct { DRIVER_CALLS(DRIVER_SLOT_) } g_drv;
static pthread_once_t g_drv_once = PTHREAD_ONCE_INIT;

static void load_driver_calls(void) {
#define DRIVER_LOAD_(name) g_drv.name = real_symbol(#name);
    DRIVER_CALLS(DRIVER_LOAD_)
}

#define DRV(name) (pthread_once(&g_drv_once, load_driver_calls), g_drv.name)

/* the ordinal of the calling thread's current context, 0 without one */
static int current_dev(void) {
    CUdevice dev = 0;
    __typeof__(&cuCtxGetDevice) get = DRV(cuCtxGetDevice);
    if (!get || get(&dev) != CUDA_SUCCESS) {
        return 0;
    }
    return dev;
}

/* --------------------------------------------------------- the hooks
 * One row per hooked entry point: its exported name, the name the driver
 * answers cuGetProcAddress for with it (and from which CUDA version on),
 * whether it is the per-thread-default-stream twin of a stream-ordered
 * call, and the real driver's function, resolved at first use. */

typedef struct {
    const char *name;
    const char *base;
    int min_version;
    int max_version; /* exclusive; 0 = none */
    int stream_ordered; /* has a _ptsz twin */
    int ptsz;
    void *hook;
    void *real;
} hook_t;

enum {
#define HOOK_ID_(name, ...) H_##name,
#define HOOK_TABLE(X)                                                     \
    X(cuGetProcAddress, "cuGetProcAddress", 11030, 12000, 0, 0)           \
    X(cuGetProcAddress_v2, "cuGetProcAddress", 12000, 0, 0, 0)            \
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
    X(cuDevicePrimaryCtxRetain, "cuDevicePrimaryCtxRetain", 7000, 0, 0, 0) \
    X(cuDevicePrimaryCtxRelease_v2, "cuDevicePrimaryCtxRelease", 11000, 0, \
      0, 0)                                                               \
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
    X(cuModuleLoad, "cuModuleLoad", 2000, 0, 0, 0)                        \
    X(cuModuleLoadData, "cuModuleLoadData", 2000, 0, 0, 0)                \
    X(cuModuleLoadDataEx, "cuModuleLoadDataEx", 2010, 0, 0, 0)            \
    X(cuModuleLoadFatBinary, "cuModuleLoadFatBinary", 2000, 0, 0, 0)      \
    X(cuModuleUnload, "cuModuleUnload", 2000, 0, 0, 0)                    \
    X(cuLibraryLoadData, "cuLibraryLoadData", 12000, 0, 0, 0)             \
    X(cuLibraryLoadFromFile, "cuLibraryLoadFromFile", 12000, 0, 0, 0)     \
    X(cuLibraryUnload, "cuLibraryUnload", 12000, 0, 0, 0)
    HOOK_TABLE(HOOK_ID_) H_COUNT
};

/* the hooks are defined as static h_<name> and exported under <name> as
 * aliases, so the table holds addresses no other library can interpose */
#define HOOK_DECL_(name, ...) static __typeof__(name) h_##name;
HOOK_TABLE(HOOK_DECL_)

static hook_t g_hooks[H_COUNT] = {
#define HOOK_ROW_(name, base, lo, hi, so, pt)                             \
    [H_##name] = {#name, base, lo, hi, so, pt, (void *)h_##name, NULL},
    HOOK_TABLE(HOOK_ROW_)};

#define HOOK_EXPORT_(name, ...)                                           \
    __typeof__(name) name __attribute__((alias("h_" #name)));
HOOK_TABLE(HOOK_EXPORT_)

static void *real_of(int id) {
    void *p = __atomic_load_n(&g_hooks[id].real, __ATOMIC_ACQUIRE);
    if (!p) {
        p = real_symbol(g_hooks[id].name);
        __atomic_store_n(&g_hooks[id].real, p, __ATOMIC_RELEASE);
    }
    return p;
}

/* the real driver's entry point of a hook; a hook whose real entry
 * point is missing returns CUDA_ERROR_NOT_FOUND */
#define REAL(name) ((__typeof__(&name))real_of(H_##name))

static hook_t *hook_by_name(const char *name) {
    for (int i = 0; i < H_COUNT; i++) {
        if (!strcmp(g_hooks[i].name, name)) {
            return &g_hooks[i];
        }
    }
    return NULL;
}

/* the hook the driver's answer for (base name, version, stream flag) is */
static hook_t *hook_for_proc(const char *base, int version, int ptsz) {
    for (int i = 0; i < H_COUNT; i++) {
        hook_t *h = &g_hooks[i];
        if (strcmp(h->base, base) || version < h->min_version ||
            (h->max_version && version >= h->max_version) ||
            (h->stream_ordered && h->ptsz != ptsz)) {
            continue;
        }
        return h;
    }
    return NULL;
}

void *dlsym(void *handle, const char *symbol) {
    dlsym_fn real = real_dlsym();
    if (!real) {
        return NULL;
    }
    if (!g_disabled && handle != RTLD_NEXT && symbol[0] == 'c' &&
        symbol[1] == 'u') {
        hook_t *h = hook_by_name(symbol);
        if (h) {
            VTPU_DBG("dlsym %s", symbol);
            /* only where that handle reaches the driver's own symbol */
            return real(handle, symbol) ? h->hook : NULL;
        }
    }
    /* a tail call: RTLD_NEXT resolves from the caller, not from here */
    return real(handle, symbol);
}

static void substitute(const char *symbol, void **pfn, int version,
                       cuuint64_t flags) {
    if (g_disabled || !pfn || !*pfn) {
        return;
    }
    int ptsz = (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) != 0;
    hook_t *h = hook_for_proc(symbol, version, ptsz);
    if (h) {
        VTPU_DBG("cuGetProcAddress %s %d %llu -> %s", symbol, version,
                 (unsigned long long)flags, h->name);
        void *unset = NULL;
        __atomic_compare_exchange_n(&h->real, &unset, *pfn, 0,
                                    __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE);
        *pfn = h->hook;
    }
}

static CUresult h_cuGetProcAddress_v2(
    const char *symbol, void **pfn, int cudaVersion, cuuint64_t flags,
    CUdriverProcAddressQueryResult *symbolStatus) {
    __typeof__(&cuGetProcAddress_v2) real = REAL(cuGetProcAddress_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    CUresult rc = real(symbol, pfn, cudaVersion, flags, symbolStatus);
    if (rc == CUDA_SUCCESS && symbol) {
        substitute(symbol, pfn, cudaVersion, flags);
    }
    return rc;
}

static CUresult h_cuGetProcAddress(const char *symbol, void **pfn,
                                   int cudaVersion, cuuint64_t flags) {
    __typeof__(&cuGetProcAddress) real = REAL(cuGetProcAddress);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    CUresult rc = real(symbol, pfn, cudaVersion, flags);
    if (rc == CUDA_SUCCESS && symbol) {
        substitute(symbol, pfn, cudaVersion, flags);
    }
    return rc;
}

/* ------------------------------------------------- handle -> (bytes, dev)
 * Open-addressing maps keyed by a 64-bit handle (device pointer, generic
 * allocation handle, CUfunction, CUmodule, CUlibrary), under g_mu. */

typedef struct {
    uint64_t key;
    uint64_t val;
    int32_t dev;
    uint8_t state; /* 0 empty, 1 live, 2 tombstone */
} ent_t;

typedef struct {
    ent_t *tab;
    size_t cap, live, used; /* used = live + tombstones */
} map_t;

static size_t key_hash(uint64_t k, size_t cap) {
    k ^= k >> 33;
    k *= 0x9E3779B97F4A7C15ull;
    k ^= k >> 29;
    return (size_t)(k & (cap - 1));
}

static ent_t *map_find(map_t *m, uint64_t key) {
    if (!m->cap) {
        return NULL;
    }
    size_t i = key_hash(key, m->cap);
    for (size_t p = 0; p < m->cap; p++, i = (i + 1) & (m->cap - 1)) {
        ent_t *e = &m->tab[i];
        if (e->state == 0) {
            return NULL;
        }
        if (e->state == 1 && e->key == key) {
            return e;
        }
    }
    return NULL;
}

static int map_grow(map_t *m) {
    size_t ncap = m->cap ? m->cap * 2 : 1024;
    if (m->live * 10 < m->cap * 3) {
        ncap = m->cap; /* mostly tombstones: rehash in place */
    }
    ent_t *nt = calloc(ncap, sizeof(*nt));
    if (!nt) {
        return -1;
    }
    for (size_t i = 0; i < m->cap; i++) {
        if (m->tab[i].state == 1) {
            size_t j = key_hash(m->tab[i].key, ncap);
            while (nt[j].state) {
                j = (j + 1) & (ncap - 1);
            }
            nt[j] = m->tab[i];
        }
    }
    free(m->tab);
    m->tab = nt;
    m->cap = ncap;
    m->used = m->live;
    return 0;
}

/* inserts or overwrites; returns the entry, NULL on host OOM */
static ent_t *map_put(map_t *m, uint64_t key) {
    ent_t *e = map_find(m, key);
    if (e) {
        return e;
    }
    if ((m->used + 1) * 10 >= m->cap * 7 && map_grow(m)) {
        return NULL;
    }
    size_t i = key_hash(key, m->cap);
    while (m->tab[i].state == 1) {
        i = (i + 1) & (m->cap - 1);
    }
    if (m->tab[i].state == 0) {
        m->used++;
    }
    m->live++;
    m->tab[i] = (ent_t){.key = key, .state = 1};
    return &m->tab[i];
}

static void map_del(map_t *m, ent_t *e) {
    e->state = 2;
    m->live--;
}

static map_t g_ptrs;    /* device pointer -> (bytes, ordinal) */
static map_t g_handles; /* cuMemCreate handle -> (bytes, ordinal) */
static map_t g_costs;   /* CUfunction / CUgraphExec -> EMA (us) */
static map_t g_modules;   /* CUmodule -> (bytes, its ordinal's bit) */
static map_t g_libraries; /* CUlibrary -> (bytes, the ordinals charged) */

static void track(map_t *m, uint64_t key, uint64_t bytes, int dev) {
    pthread_mutex_lock(&g_mu);
    ent_t *e = map_put(m, key);
    if (e) {
        e->val = bytes;
        e->dev = dev;
    }
    pthread_mutex_unlock(&g_mu);
    if (!e) {
        /* host OOM growing the table: release the charge now rather than
         * hold it for a handle that can never be matched at free */
        vtpu_free(g_region, g_slot, dev, bytes, VTPU_MEM_BUFFER);
    }
}

static int untrack(map_t *m, uint64_t key, uint64_t *bytes, int *dev) {
    pthread_mutex_lock(&g_mu);
    ent_t *e = map_find(m, key);
    if (e) {
        *bytes = e->val;
        *dev = e->dev;
        map_del(m, e);
    }
    pthread_mutex_unlock(&g_mu);
    return e != NULL;
}

/* -------------------------------------------------- allocation and release
 * pre_alloc_check enforces the cap before the driver is asked (OOM at
 * allocation time, the cap summed over every process of the slice);
 * post_alloc_track releases the charge if the driver failed, or settles
 * it to the bytes the driver really gave and records the handle. */

static CUresult pre_alloc_check(int dev, uint64_t est) {
    if (!accounting(dev) || est == 0 ||
        !vtpu_try_alloc(g_region, g_slot, dev, est, VTPU_MEM_BUFFER)) {
        return CUDA_SUCCESS;
    }
    uint64_t used = vtpu_device_used(g_region, dev);
    /* frameworks retry rejected allocations in tight loops: log at most
     * once per second so stderr stays readable */
    static uint64_t last_log_us;
    uint64_t log_now = now_mono_us();
    if (last_log_us == 0 || log_now - last_log_us > 1000000ull) {
        last_log_us = log_now;
        fprintf(stderr,
                "vtpu: HBM limit exceeded on device %d "
                "(request %llu, used %llu, limit %llu)\n", dev,
                (unsigned long long)est, (unsigned long long)used,
                (unsigned long long)g_region->limit[dev]);
    }
    if (env_is_true("VTPU_ACTIVE_OOM_KILLER")) {
        _exit(137);
    }
    return CUDA_ERROR_OUT_OF_MEMORY;
}

/* the library `addr` lies in, for the trace */
static const char *library_of(const void *addr) {
    Dl_info info;
    return addr && dladdr(addr, &info) && info.dli_fname ? info.dli_fname
                                                          : "-";
}

static void post_alloc_track(CUresult rc, map_t *m, uint64_t key, int dev,
                             uint64_t est, uint64_t actual,
                             const void *caller) {
    if (!accounting(dev) || est == 0) {
        return;
    }
    if (rc != CUDA_SUCCESS) {
        vtpu_free(g_region, g_slot, dev, est, VTPU_MEM_BUFFER);
        return;
    }
    if (g_debug) {
        VTPU_DBG("alloc %llu dev %d from %s", (unsigned long long)actual,
                 dev, library_of(caller));
    }
    if (actual != est) {
        vtpu_free(g_region, g_slot, dev, est, VTPU_MEM_BUFFER);
        vtpu_account(g_region, g_slot, dev, actual, VTPU_MEM_BUFFER);
    }
    track(m, key, actual, dev);
}

static void release(map_t *m, uint64_t key, CUresult rc, uint64_t bytes,
                    int dev) {
    if (rc != CUDA_SUCCESS) {
        track(m, key, bytes, dev); /* not freed after all: still held */
    } else if (accounting(dev)) {
        vtpu_free(g_region, g_slot, dev, bytes, VTPU_MEM_BUFFER);
    }
}

static CUresult h_cuMemAlloc_v2(CUdeviceptr *dptr, size_t bytesize) {
    __typeof__(&cuMemAlloc_v2) real = REAL(cuMemAlloc_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    int dev = current_dev();
    CUresult rc = pre_alloc_check(dev, bytesize);
    if (rc != CUDA_SUCCESS) {
        return rc;
    }
    rc = real(dptr, bytesize);
    post_alloc_track(rc, &g_ptrs, rc == CUDA_SUCCESS ? *dptr : 0, dev,
                     bytesize, bytesize, __builtin_return_address(0));
    return rc;
}

static CUresult h_cuMemAllocPitch_v2(CUdeviceptr *dptr, size_t *pPitch,
                                     size_t WidthInBytes, size_t Height,
                                     unsigned int ElementSizeBytes) {
    __typeof__(&cuMemAllocPitch_v2) real = REAL(cuMemAllocPitch_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    int dev = current_dev();
    uint64_t est = (uint64_t)WidthInBytes * Height;
    CUresult rc = pre_alloc_check(dev, est);
    if (rc != CUDA_SUCCESS) {
        return rc;
    }
    rc = real(dptr, pPitch, WidthInBytes, Height, ElementSizeBytes);
    post_alloc_track(rc, &g_ptrs, rc == CUDA_SUCCESS ? *dptr : 0, dev, est,
                     rc == CUDA_SUCCESS ? (uint64_t)*pPitch * Height : 0,
                     __builtin_return_address(0));
    return rc;
}

#define ASYNC_ALLOC_HOOK(name, params, ...)                               \
    static CUresult h_##name params {                                     \
        __typeof__(&name) real = REAL(name);                              \
        if (!real) {                                                      \
            return CUDA_ERROR_NOT_FOUND;                                  \
        }                                                                 \
        int dev = current_dev();                                          \
        CUresult rc = pre_alloc_check(dev, bytesize);                     \
        if (rc != CUDA_SUCCESS) {                                         \
            return rc;                                                    \
        }                                                                 \
        rc = real(__VA_ARGS__);                                           \
        post_alloc_track(rc, &g_ptrs, rc == CUDA_SUCCESS ? *dptr : 0,     \
                         dev, bytesize, bytesize,                         \
                         __builtin_return_address(0));                    \
        return rc;                                                        \
    }

ASYNC_ALLOC_HOOK(cuMemAllocAsync,
                 (CUdeviceptr *dptr, size_t bytesize, CUstream hStream),
                 dptr, bytesize, hStream)
ASYNC_ALLOC_HOOK(cuMemAllocAsync_ptsz,
                 (CUdeviceptr *dptr, size_t bytesize, CUstream hStream),
                 dptr, bytesize, hStream)
ASYNC_ALLOC_HOOK(cuMemAllocFromPoolAsync,
                 (CUdeviceptr *dptr, size_t bytesize, CUmemoryPool pool,
                  CUstream hStream),
                 dptr, bytesize, pool, hStream)
ASYNC_ALLOC_HOOK(cuMemAllocFromPoolAsync_ptsz,
                 (CUdeviceptr *dptr, size_t bytesize, CUmemoryPool pool,
                  CUstream hStream),
                 dptr, bytesize, pool, hStream)

/* physical memory of the virtual memory management API (PyTorch's
 * expandable segments): charged when created, not when mapped */
static CUresult h_cuMemCreate(CUmemGenericAllocationHandle *handle,
                              size_t size, const CUmemAllocationProp *prop,
                              unsigned long long flags) {
    __typeof__(&cuMemCreate) real = REAL(cuMemCreate);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    int dev = prop && prop->location.type == CU_MEM_LOCATION_TYPE_DEVICE
                  ? prop->location.id : -1; /* host memory: not charged */
    CUresult rc = pre_alloc_check(dev, size);
    if (rc != CUDA_SUCCESS) {
        return rc;
    }
    rc = real(handle, size, prop, flags);
    post_alloc_track(rc, &g_handles, rc == CUDA_SUCCESS ? *handle : 0, dev,
                     size, size, __builtin_return_address(0));
    return rc;
}

static CUresult h_cuMemFree_v2(CUdeviceptr dptr) {
    __typeof__(&cuMemFree_v2) real = REAL(cuMemFree_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    /* untracked before the driver frees it: after, another thread could
     * be handed the same address and track it first */
    uint64_t bytes;
    int dev;
    if (!untrack(&g_ptrs, dptr, &bytes, &dev)) {
        return real(dptr);
    }
    CUresult rc = real(dptr);
    release(&g_ptrs, dptr, rc, bytes, dev);
    return rc;
}

#define ASYNC_FREE_HOOK(name)                                             \
    static CUresult h_##name(CUdeviceptr dptr, CUstream hStream) {        \
        __typeof__(&name) real = REAL(name);                              \
        if (!real) {                                                      \
            return CUDA_ERROR_NOT_FOUND;                                  \
        }                                                                 \
        uint64_t bytes;                                                   \
        int dev;                                                          \
        if (!untrack(&g_ptrs, dptr, &bytes, &dev)) {                      \
            return real(dptr, hStream);                                   \
        }                                                                 \
        CUresult rc = real(dptr, hStream);                                \
        release(&g_ptrs, dptr, rc, bytes, dev);                           \
        return rc;                                                        \
    }

ASYNC_FREE_HOOK(cuMemFreeAsync)
ASYNC_FREE_HOOK(cuMemFreeAsync_ptsz)

static CUresult h_cuMemRelease(CUmemGenericAllocationHandle handle) {
    __typeof__(&cuMemRelease) real = REAL(cuMemRelease);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    uint64_t bytes;
    int dev;
    if (!untrack(&g_handles, handle, &bytes, &dev)) {
        return real(handle);
    }
    CUresult rc = real(handle);
    release(&g_handles, handle, rc, bytes, dev);
    return rc;
}

/* ------------------------------------------------------ reported memory
 * The container sees only its slice: total is the cap, and free is the
 * cap less what the slice uses (never more than the card really has). */

static CUresult h_cuMemGetInfo_v2(size_t *free, size_t *total) {
    __typeof__(&cuMemGetInfo_v2) real = REAL(cuMemGetInfo_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    CUresult rc = real(free, total);
    int dev = current_dev();
    if (rc != CUDA_SUCCESS || !accounting(dev) || !g_region->limit[dev]) {
        return rc;
    }
    uint64_t limit = g_region->limit[dev];
    uint64_t used = vtpu_device_used(g_region, dev);
    uint64_t left = used >= limit ? 0 : limit - used;
    *total = limit;
    if (*free > left) {
        *free = left;
    }
    return rc;
}

/* ------------------------------------------------------------ loaded code
 * The counterpart of register_loaded_executable: a module or library the
 * process loads is charged, as module memory, the device code its image
 * holds for the device's SM (vtpu_image.h has the rules), read from the
 * image or file the caller hands the driver. The driver loads it first; a
 * charge the slice cannot hold is refused after it, as libvtpu.so refuses
 * a compiled program: the ordinals already charged are rolled back, the
 * image is unloaded through the driver, the out-handle set to NULL and
 * CUDA_ERROR_OUT_OF_MEMORY returned. Under VTPU_OVERSUBSCRIBE the same
 * charge spills instead. The charge is released once the driver's unload
 * succeeds.
 *
 * The ordinals: a CUmodule belongs to the current context, so its ordinal
 * is charged. A CUlibrary is context-independent, as an SPMD executable is
 * multi-device: every ordinal whose primary context the process holds
 * through the shim is charged, and an ordinal whose primary context is
 * retained later is charged then for every library still loaded (as the
 * context's footprint is, without a refusal). Releasing a primary context
 * frees what it held on its ordinal: that ordinal's charge of every
 * library, taken again at the next retain, and every module loaded on the
 * ordinal (the driver unloads a context's modules with it; a module of a
 * context the process created itself on that ordinal is freed too, as the
 * shim does not tell the two apart). A library is charged the same bytes
 * on every ordinal, read for the SM of the device current at its load
 * (ordinal 0 without a context): a node's cards are of one model. */

static uint32_t g_retained; /* primary contexts held, by ordinal; g_mu */

/* the compute capability of `dev`; 0.0 (no fatbin entry matches, so an
 * image is charged by the unparsed rule) where the driver does not say */
static void device_cc(int dev, int *major, int *minor) {
    __typeof__(&cuDeviceGetAttribute) attr = DRV(cuDeviceGetAttribute);
    if (!attr ||
        attr(major, CU_DEVICE_ATTRIBUTE_COMPUTE_CAPABILITY_MAJOR, dev) !=
            CUDA_SUCCESS ||
        attr(minor, CU_DEVICE_ATTRIBUTE_COMPUTE_CAPABILITY_MINOR, dev) !=
            CUDA_SUCCESS) {
        *major = *minor = 0;
    }
}

/* the charge of the image (or the file at `path`) a load hands the
 * driver, for the SM of `dev`; every load is named in the trace */
static uint64_t code_bytes(const char *entry, const void *image,
                           const char *path, int dev) {
    int major = 0, minor = 0;
    device_cc(dev, &major, &minor);
    vtpu_image_charge_t c = {0, VTPU_IMAGE_UNPARSED, 0};
    if (!path) {
        c = vtpu_image_charge(image, 0, major, minor);
    } else if (vtpu_image_charge_file(path, major, minor, &c)) {
        VTPU_DBG("load %s: cannot read %s", entry, path);
    }
    VTPU_DBG("load %s %llu %s sm_%d dev %d sm_%d%d %s", entry,
             (unsigned long long)c.bytes, vtpu_image_form(c.form), c.arch,
             dev, major, minor, path ? path : library_of(image));
    return c.bytes;
}

/* charges `bytes` of module memory on every ordinal in `mask` (g_mu held);
 * returns the first ordinal that refuses, the others rolled back, or -1 */
static int charge_code(uint32_t mask, uint64_t bytes) {
    for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
        if ((mask >> d & 1) &&
            vtpu_try_alloc(g_region, g_slot, d, bytes, VTPU_MEM_MODULE)) {
            for (int r = 0; r < d; r++) {
                if (mask >> r & 1) {
                    vtpu_free(g_region, g_slot, r, bytes, VTPU_MEM_MODULE);
                }
            }
            return d;
        }
    }
    return -1;
}

static void free_code(uint32_t mask, uint64_t bytes) {
    for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
        if (mask >> d & 1) {
            vtpu_free(g_region, g_slot, d, bytes, VTPU_MEM_MODULE);
        }
    }
}

/* records `handle`'s charge (g_mu held); releases it on host OOM, as
 * track() does, since the handle could never be matched at unload */
static void put_code(map_t *m, uint64_t handle, uint32_t mask,
                     uint64_t bytes) {
    ent_t *e = map_put(m, handle);
    if (e) {
        e->val = bytes;
        e->dev = (int32_t)mask;
    } else {
        free_code(mask, bytes);
    }
}

/* after the driver loaded `handle`: charge a module on `dev`, a library
 * on every retained ordinal; returns the ordinal that refused, or -1 */
static int admit_code(map_t *m, uint64_t handle, int dev, uint64_t bytes) {
    pthread_mutex_lock(&g_mu);
    uint32_t mask = m == &g_libraries ? g_retained : 1u << dev;
    int refused = charge_code(mask, bytes);
    if (refused < 0) {
        put_code(m, handle, mask, bytes);
    }
    pthread_mutex_unlock(&g_mu);
    if (refused >= 0) {
        fprintf(stderr,
                "vtpu: HBM limit exceeded on device %d (device code of %llu "
                "bytes, used %llu, limit %llu)\n", refused,
                (unsigned long long)bytes,
                (unsigned long long)vtpu_device_used(g_region, refused),
                (unsigned long long)g_region->limit[refused]);
    }
    return refused;
}

/* a load entry point: `image` or `path` is what it loads, `out` its
 * out-handle, `unload` the driver's unload of that handle */
#define CODE_LOAD_HOOK(name, map, out, unload, image, path, params, ...)   \
    static CUresult h_##name params {                                     \
        __typeof__(&name) real = REAL(name);                              \
        if (!real) {                                                      \
            return CUDA_ERROR_NOT_FOUND;                                  \
        }                                                                 \
        int dev = current_dev();                                          \
        uint64_t bytes =                                                  \
            accounting(dev) ? code_bytes(#name, image, path, dev) : 0;    \
        CUresult rc = real(__VA_ARGS__);                                  \
        if (rc != CUDA_SUCCESS || bytes == 0 ||                           \
            admit_code(map, (uint64_t)(uintptr_t)*out, dev, bytes) < 0) { \
            return rc;                                                    \
        }                                                                 \
        __typeof__(&unload) drop = REAL(unload);                          \
        if (drop) {                                                       \
            drop(*out);                                                   \
        }                                                                 \
        *out = NULL;                                                      \
        return CUDA_ERROR_OUT_OF_MEMORY;                                  \
    }

#define LIBRARY_OPTION_ARGS                                               \
    jitOptions, jitOptionsValues, numJitOptions, libraryOptions,          \
        libraryOptionValues, numLibraryOptions

CODE_LOAD_HOOK(cuModuleLoad, &g_modules, module, cuModuleUnload, NULL,
               fname, (CUmodule *module, const char *fname), module, fname)
CODE_LOAD_HOOK(cuModuleLoadData, &g_modules, module, cuModuleUnload, image,
               NULL, (CUmodule *module, const void *image), module, image)
CODE_LOAD_HOOK(cuModuleLoadDataEx, &g_modules, module, cuModuleUnload,
               image, NULL,
               (CUmodule *module, const void *image, unsigned int numOptions,
                CUjit_option *options, void **optionValues),
               module, image, numOptions, options, optionValues)
CODE_LOAD_HOOK(cuModuleLoadFatBinary, &g_modules, module, cuModuleUnload,
               fatCubin, NULL, (CUmodule *module, const void *fatCubin),
               module, fatCubin)
CODE_LOAD_HOOK(cuLibraryLoadData, &g_libraries, library, cuLibraryUnload,
               code, NULL,
               (CUlibrary *library, const void *code,
                VTPU_CU_LIBRARY_OPTIONS),
               library, code, LIBRARY_OPTION_ARGS)
CODE_LOAD_HOOK(cuLibraryLoadFromFile, &g_libraries, library,
               cuLibraryUnload, NULL, fileName,
               (CUlibrary *library, const char *fileName,
                VTPU_CU_LIBRARY_OPTIONS),
               library, fileName, LIBRARY_OPTION_ARGS)

#define CODE_UNLOAD_HOOK(name, type, map)                                 \
    static CUresult h_##name(type handle) {                               \
        __typeof__(&name) real = REAL(name);                              \
        if (!real) {                                                      \
            return CUDA_ERROR_NOT_FOUND;                                  \
        }                                                                 \
        uint64_t key = (uint64_t)(uintptr_t)handle, bytes;                \
        int mask;                                                         \
        if (!untrack(map, key, &bytes, &mask)) {                          \
            return real(handle);                                          \
        }                                                                 \
        CUresult rc = real(handle);                                       \
        if (rc == CUDA_SUCCESS) {                                         \
            free_code((uint32_t)mask, bytes);                             \
        } else { /* not unloaded after all: still held */                 \
            pthread_mutex_lock(&g_mu);                                    \
            put_code(map, key, (uint32_t)mask, bytes);                    \
            pthread_mutex_unlock(&g_mu);                                  \
        }                                                                 \
        return rc;                                                        \
    }

CODE_UNLOAD_HOOK(cuModuleUnload, CUmodule, &g_modules)
CODE_UNLOAD_HOOK(cuLibraryUnload, CUlibrary, &g_libraries)

/* a primary context retained afresh on `dev`: the ordinal takes the
 * charge of every library loaded; returns the bytes charged */
static uint64_t code_on_retain(int dev) {
    uint64_t bytes = 0;
    pthread_mutex_lock(&g_mu);
    g_retained |= 1u << dev;
    for (size_t i = 0; i < g_libraries.cap; i++) {
        ent_t *e = &g_libraries.tab[i];
        if (e->state == 1 && !(e->dev >> dev & 1)) {
            e->dev |= 1 << dev;
            bytes += e->val;
        }
    }
    if (bytes) {
        vtpu_account(g_region, g_slot, dev, bytes, VTPU_MEM_MODULE);
    }
    pthread_mutex_unlock(&g_mu);
    return bytes;
}

/* `dev`'s primary context released: what it held on the ordinal is freed */
static void code_on_release(int dev) {
    uint64_t bytes = 0;
    pthread_mutex_lock(&g_mu);
    g_retained &= ~(1u << dev);
    for (size_t i = 0; i < g_libraries.cap; i++) {
        ent_t *e = &g_libraries.tab[i];
        if (e->state == 1 && (e->dev >> dev & 1)) {
            e->dev &= ~(1 << dev);
            bytes += e->val;
        }
    }
    for (size_t i = 0; i < g_modules.cap; i++) {
        ent_t *e = &g_modules.tab[i];
        if (e->state == 1 && e->dev == 1 << dev) {
            bytes += e->val;
            map_del(&g_modules, e);
        }
    }
    if (bytes) {
        vtpu_free(g_region, g_slot, dev, bytes, VTPU_MEM_MODULE);
    }
    pthread_mutex_unlock(&g_mu);
}

/* ------------------------------------------------------ context footprint
 * A primary context reserves device memory outside any allocation. It is
 * charged once, as context-kind usage, when the context is created (the
 * counterpart of w_Client_Create's context accounting), and released when
 * its last retain is released. The footprint is the drop in free bytes
 * around the creation, read from a short-lived context of the same
 * device: free bytes cannot be read before the process has a context.
 * Under CUDA_MODULE_LOADING=EAGER the driver loads every library loaded
 * so far into the context as it creates it: that part of the drop is the
 * libraries' module charge, taken at the same time, and is not charged
 * twice. */

static uint64_t g_ctx_bytes[VTPU_MAX_DEVICES]; /* under g_mu */
static int g_eager; /* CUDA_MODULE_LOADING=EAGER */

static int primary_active(CUdevice dev) {
    unsigned int flags = 0;
    int active = 1;
    __typeof__(&cuDevicePrimaryCtxGetState) state =
        DRV(cuDevicePrimaryCtxGetState);
    if (!state || state(dev, &flags, &active) != CUDA_SUCCESS) {
        return 1; /* unknown: measure nothing */
    }
    return active;
}

static CUresult h_cuDevicePrimaryCtxRetain(CUcontext *pctx, CUdevice dev) {
    __typeof__(&cuDevicePrimaryCtxRetain) real =
        REAL(cuDevicePrimaryCtxRetain);
    __typeof__(&cuMemGetInfo_v2) info = REAL(cuMemGetInfo_v2);
    __typeof__(&cuCtxCreate_v2) create = DRV(cuCtxCreate_v2);
    __typeof__(&cuCtxDestroy_v2) destroy = DRV(cuCtxDestroy_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    int fresh = accounting(dev) && !primary_active(dev);
    CUcontext probe = NULL;
    size_t before = 0, after = 0, total = 0;
    if (fresh && info && create && destroy &&
        create(&probe, 0, dev) == CUDA_SUCCESS &&
        info(&before, &total) != CUDA_SUCCESS) {
        destroy(probe);
        probe = NULL;
    }
    CUresult rc = real(pctx, dev);
    uint64_t code = rc == CUDA_SUCCESS && fresh ? code_on_retain(dev) : 0;
    if (probe) {
        int measured = info(&after, &total) == CUDA_SUCCESS;
        destroy(probe); /* pops it: the caller's current context is back */
        uint64_t drop = before > after ? before - after : 0;
        VTPU_DBG("retain dev %d: free bytes dropped %llu, libraries %llu",
                 dev, (unsigned long long)drop, (unsigned long long)code);
        if (g_eager) {
            drop = drop > code ? drop - code : 0;
        }
        if (rc == CUDA_SUCCESS && measured && drop) {
            vtpu_account(g_region, g_slot, dev, drop, VTPU_MEM_CONTEXT);
            pthread_mutex_lock(&g_mu);
            g_ctx_bytes[dev] += drop;
            pthread_mutex_unlock(&g_mu);
        }
    }
    return rc;
}

static CUresult h_cuDevicePrimaryCtxRelease_v2(CUdevice dev) {
    __typeof__(&cuDevicePrimaryCtxRelease_v2) real =
        REAL(cuDevicePrimaryCtxRelease_v2);
    if (!real) {
        return CUDA_ERROR_NOT_FOUND;
    }
    CUresult rc = real(dev);
    if (rc == CUDA_SUCCESS && accounting(dev) && !primary_active(dev)) {
        pthread_mutex_lock(&g_mu);
        uint64_t bytes = g_ctx_bytes[dev];
        g_ctx_bytes[dev] = 0;
        pthread_mutex_unlock(&g_mu);
        if (bytes) {
            vtpu_free(g_region, g_slot, dev, bytes, VTPU_MEM_CONTEXT);
        }
        code_on_release(dev);
    }
    return rc;
}

/* ---------------------------------------------------- duty-cycle bucket
 * Every launch is charged to the slice's shared token bucket
 * (vtpu_rate_limit) on the device of the calling thread's context. The
 * cost is VTPU_EXEC_COST_US when the operator pinned it; otherwise an EMA
 * of the launch's own device time per CUfunction (per CUgraphExec for a
 * graph), as libvtpu.so keeps one per executable.
 *
 * Timing: one launch at a time is bracketed by a pair of events on its
 * stream, so the pair times that launch alone on its stream, with no
 * queue wait ahead of it counted; the pair is read with cuEventQuery at a
 * later launch, never synchronized, so the stream is never serialized.
 * A CUfunction not timed yet costs the mean of all timed ones (the flat
 * bootstrap before the first).
 *
 * Batching: a framework launches hundreds of short kernels a step, and a
 * region lock each would tax a host-bound path; so costs add up per
 * device and the bucket is charged once they reach CHARGE_BATCH_US. A
 * launch costing at least that much is charged on its own, as libvtpu.so
 * charges every Execute, and the average rate is vtpu_rate_limit's. */

#define CHARGE_BATCH_US 1000ull

static uint64_t g_pending_us[VTPU_MAX_DEVICES]; /* atomics */
static uint64_t g_mean_us = 0;                  /* under g_mu */

static void charge(int dev, uint64_t cost) {
    uint64_t pending = __atomic_add_fetch(&g_pending_us[dev], cost,
                                          __ATOMIC_ACQ_REL);
    if (pending < CHARGE_BATCH_US) {
        return;
    }
    uint64_t take = __atomic_exchange_n(&g_pending_us[dev], 0,
                                        __ATOMIC_ACQ_REL);
    while (take > 0) { /* a cost above the capacity is never granted whole */
        uint64_t part =
            take < VTPU_DUTY_BUCKET_CAP_US ? take : VTPU_DUTY_BUCKET_CAP_US;
        vtpu_rate_limit(g_region, dev, part);
        take -= part;
    }
}

static uint64_t cost_of(const void *key) {
    uint64_t cost = 0;
    pthread_mutex_lock(&g_mu);
    ent_t *e = map_find(&g_costs, (uint64_t)(uintptr_t)key);
    cost = e ? e->val : g_mean_us;
    pthread_mutex_unlock(&g_mu);
    return cost ? cost : g_exec_cost_us;
}

static void ema_update(const void *key, uint64_t us) {
    pthread_mutex_lock(&g_mu);
    ent_t *e = map_put(&g_costs, (uint64_t)(uintptr_t)key);
    if (e) {
        e->val = e->val ? (7 * e->val + us) / 8 : us;
    }
    g_mean_us = g_mean_us ? (7 * g_mean_us + us) / 8 : us;
    pthread_mutex_unlock(&g_mu);
}

static struct {
    pthread_mutex_t mu;
    CUevent start, end; /* created at the first timed launch */
    const void *key;
    int busy;  /* a launch holds the pair */
    int armed; /* its end event is recorded: read it when it completes */
} g_timing = {.mu = PTHREAD_MUTEX_INITIALIZER};

/* read the timed launch if its end event has completed */
static void timing_poll(void) {
    if (pthread_mutex_trylock(&g_timing.mu)) {
        return;
    }
    if (g_timing.armed) {
        CUresult q = DRV(cuEventQuery)(g_timing.end);
        float ms = 0.0f;
        if (q == CUDA_SUCCESS &&
            DRV(cuEventElapsedTime)(&ms, g_timing.start, g_timing.end) ==
                CUDA_SUCCESS) {
            uint64_t us = (uint64_t)(ms * 1000.0f);
            ema_update(g_timing.key, us ? us : 1);
        }
        if (q != CUDA_ERROR_NOT_READY) {
            g_timing.armed = g_timing.busy = 0;
        }
    }
    pthread_mutex_unlock(&g_timing.mu);
}

/* take the event pair for this launch; returns 1 if it did */
static int timing_begin(const void *key, CUstream stream) {
    if (!DRV(cuEventRecord) || !g_drv.cuEventQuery ||
        !g_drv.cuEventElapsedTime || !g_drv.cuEventCreate ||
        pthread_mutex_trylock(&g_timing.mu)) {
        return 0;
    }
    int took = 0;
    if (!g_timing.busy) {
        if (!g_timing.start &&
            (g_drv.cuEventCreate(&g_timing.start, 0) != CUDA_SUCCESS ||
             g_drv.cuEventCreate(&g_timing.end, 0) != CUDA_SUCCESS)) {
            g_timing.start = g_timing.end = NULL;
        } else if (g_drv.cuEventRecord(g_timing.start, stream) ==
                   CUDA_SUCCESS) {
            g_timing.key = key;
            g_timing.busy = took = 1;
        }
    }
    pthread_mutex_unlock(&g_timing.mu);
    return took;
}

static void timing_end(CUstream stream, CUresult launched) {
    pthread_mutex_lock(&g_timing.mu);
    if (launched == CUDA_SUCCESS &&
        g_drv.cuEventRecord(g_timing.end, stream) == CUDA_SUCCESS) {
        g_timing.armed = 1;
    } else {
        g_timing.busy = 0;
    }
    pthread_mutex_unlock(&g_timing.mu);
}

/* before a launch: returns 1 if the launch is to be timed */
static int launch_begin(const void *key, CUstream stream) {
    if (!g_region || g_core_policy_off) {
        return 0;
    }
    int dev = current_dev();
    if (dev < 0 || dev >= VTPU_MAX_DEVICES) {
        dev = 0;
    }
    uint64_t pct = g_region->sm_limit[dev];
    if (pct == 0 || pct >= 100) {
        /* uncapped: only the monitor's priority block can hold it */
        vtpu_rate_limit(g_region, dev, 0);
        return 0;
    }
    CUstreamCaptureStatus capture = CU_STREAM_CAPTURE_STATUS_NONE;
    if (DRV(cuStreamIsCapturing) &&
        g_drv.cuStreamIsCapturing(stream, &capture) == CUDA_SUCCESS &&
        capture != CU_STREAM_CAPTURE_STATUS_NONE) {
        return 0; /* recorded into a graph: charged when the graph runs */
    }
    if (g_exec_cost_fixed) {
        charge(dev, g_exec_cost_us);
        return 0;
    }
    timing_poll();
    charge(dev, cost_of(key));
    return timing_begin(key, stream);
}

#define LAUNCH_HOOK(name, key, stream, params, ...)                       \
    static CUresult h_##name params {                                     \
        __typeof__(&name) real = REAL(name);                              \
        if (!real) {                                                      \
            return CUDA_ERROR_NOT_FOUND;                                  \
        }                                                                 \
        int timed = launch_begin((key), (stream));                        \
        CUresult rc = real(__VA_ARGS__);                                  \
        if (timed) {                                                      \
            timing_end((stream), rc);                                     \
        }                                                                 \
        return rc;                                                        \
    }

#define KERNEL_PARAMS                                                     \
    (CUfunction f, unsigned int gridDimX, unsigned int gridDimY,          \
     unsigned int gridDimZ, unsigned int blockDimX, unsigned int blockDimY, \
     unsigned int blockDimZ, unsigned int sharedMemBytes, CUstream hStream, \
     void **kernelParams, void **extra)
#define KERNEL_ARGS                                                       \
    f, gridDimX, gridDimY, gridDimZ, blockDimX, blockDimY, blockDimZ,     \
        sharedMemBytes, hStream, kernelParams, extra
#define COOPERATIVE_PARAMS                                                \
    (CUfunction f, unsigned int gridDimX, unsigned int gridDimY,          \
     unsigned int gridDimZ, unsigned int blockDimX, unsigned int blockDimY, \
     unsigned int blockDimZ, unsigned int sharedMemBytes, CUstream hStream, \
     void **kernelParams)
#define COOPERATIVE_ARGS                                                  \
    f, gridDimX, gridDimY, gridDimZ, blockDimX, blockDimY, blockDimZ,     \
        sharedMemBytes, hStream, kernelParams
#define EX_PARAMS                                                         \
    (const CUlaunchConfig *config, CUfunction f, void **kernelParams,     \
     void **extra)

LAUNCH_HOOK(cuLaunchKernel, f, hStream, KERNEL_PARAMS, KERNEL_ARGS)
LAUNCH_HOOK(cuLaunchKernel_ptsz, f, hStream, KERNEL_PARAMS, KERNEL_ARGS)
LAUNCH_HOOK(cuLaunchCooperativeKernel, f, hStream, COOPERATIVE_PARAMS,
            COOPERATIVE_ARGS)
LAUNCH_HOOK(cuLaunchCooperativeKernel_ptsz, f, hStream, COOPERATIVE_PARAMS,
            COOPERATIVE_ARGS)
LAUNCH_HOOK(cuLaunchKernelEx, f, config ? config->hStream : NULL, EX_PARAMS,
            config, f, kernelParams, extra)
LAUNCH_HOOK(cuLaunchKernelEx_ptsz, f, config ? config->hStream : NULL,
            EX_PARAMS, config, f, kernelParams, extra)
LAUNCH_HOOK(cuGraphLaunch, hGraphExec, hStream,
            (CUgraphExec hGraphExec, CUstream hStream), hGraphExec, hStream)
LAUNCH_HOOK(cuGraphLaunch_ptsz, hGraphExec, hStream,
            (CUgraphExec hGraphExec, CUstream hStream), hGraphExec, hStream)

/* ------------------------------------------------------------ lifecycle */

__attribute__((constructor)) static void vtpu_init(void) {
    g_debug = env_is_true("VTPU_DEBUG");
    const char *loading = getenv("CUDA_MODULE_LOADING");
    g_eager = loading && !strcmp(loading, "EAGER");
    if (env_is_true("VTPU_DISABLE_CONTROL")) {
        g_disabled = 1;
        return;
    }
    const char *cache = getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE");
    if (!cache) {
        g_disabled = 1;
        return;
    }
    char path[4096];
    snprintf(path, sizeof(path), "%s/vtpu.cache", cache);
    vtpu_shared_region_t *region = vtpu_shm_open(path);
    if (!region) {
        fprintf(stderr, "vtpu: cannot open shared region %s; control off\n",
                path);
        g_disabled = 1;
        return;
    }
    /* publish limits from the Allocate-time env contract */
    vtpu_shm_lock(region);
    for (int i = 0; i < VTPU_MAX_DEVICES; i++) {
        char name[64];
        snprintf(name, sizeof(name), "VTPU_DEVICE_MEMORY_LIMIT_%d", i);
        const char *v = getenv(name);
        if (v) {
            region->limit[i] = strtoull(v, NULL, 10);
            if (i + 1 > (int)region->num_devices) {
                region->num_devices = i + 1;
            }
        }
    }
    const char *core = getenv("VTPU_DEVICE_CORE_LIMIT");
    if (core) {
        uint64_t pct = strtoull(core, NULL, 10);
        for (int i = 0; i < VTPU_MAX_DEVICES; i++) {
            region->sm_limit[i] = pct;
        }
    }
    const char *policy = getenv("VTPU_CORE_UTILIZATION_POLICY");
    if (policy && !strcmp(policy, "disable")) {
        g_core_policy_off = 1; /* memory still enforced; duty cycle freed */
    }
    const char *prio = getenv("VTPU_TASK_PRIORITY");
    if (prio) {
        region->priority = atoi(prio);
    }
    if (env_is_true("VTPU_OVERSUBSCRIBE")) {
        region->oversubscribe = 1;
    }
    const char *cost = getenv("VTPU_EXEC_COST_US");
    if (cost) {
        /* explicit operator override: a flat cost per launch, no timing */
        g_exec_cost_us = strtoull(cost, NULL, 10);
        g_exec_cost_fixed = 1;
    }
    vtpu_shm_unlock(region);
    g_slot = vtpu_proc_attach(region, (int32_t)getpid());
    g_region = region;
}

__attribute__((destructor)) static void vtpu_fini(void) {
    if (g_region && g_slot >= 0) {
        g_slot = -1; /* hooks running during exit stop accounting */
        vtpu_proc_detach(g_region, (int32_t)getpid());
        /* the mapping stays: a thread still inside a hook may read it,
         * and the process is exiting */
    }
}
