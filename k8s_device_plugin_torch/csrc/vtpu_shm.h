/*
 * vTPU shared-region ABI: the port's copy of lib/tpu/vtpu_shm.h.
 *
 * One cache file per container, mmapped by (a) the in-container enforcement
 * shim (libvtpu_cuda.so, built from vtpu_cuda_preload.c, or the port's
 * cooperative limiter) and (b) the host-side vTPUmonitor. The layout is the
 * contract: it must match lib/tpu/vtpu_shm.h and the Python mirror in
 * k8s_device_plugin_torch/shm/region.py bit for bit (tests/
 * test_torch_enforce.py holds all three equal), so the monitor reads a
 * region this copy writes as one the JAX package's shim wrote.
 *
 * TPU-native counterpart of the reference's HAMi-core sharedRegionT
 * (cmd/vGPUmonitor/cudevshr.go:42-58): per-device HBM limits + usage broken
 * down by kind, per-process slots, and the monitor->shim feedback cells
 * (utilization switch, recent-kernel flag, priority) used for duty-cycle
 * arbitration.
 */

#ifndef VTPU_SHM_H
#define VTPU_SHM_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define VTPU_SHM_MAGIC   0x56545055u /* "VTPU" */
/* v2: duty-cycle token bucket moved into the region (fields appended) so
 * every process sharing a slice drains ONE bucket; v1 files are smaller
 * than the v2 struct and re-initialize on open */
#define VTPU_SHM_VERSION 2u
#define VTPU_MAX_DEVICES 16
#define VTPU_MAX_PROCS   256

/* usage kinds (mirror context/module/buffer/offset of the reference) */
enum {
    VTPU_MEM_CONTEXT = 0, /* runtime/executable context */
    VTPU_MEM_MODULE  = 1, /* compiled program (HLO module) */
    VTPU_MEM_BUFFER  = 2, /* data buffers */
    VTPU_MEM_OFFSET  = 3, /* misc/other */
    VTPU_MEM_KINDS   = 4
};

typedef struct {
    uint64_t kinds[VTPU_MEM_KINDS];
    uint64_t total;
} vtpu_device_memory_t;

typedef struct {
    int32_t  pid;      /* in-container pid (0 = slot free) */
    int32_t  hostpid;  /* host pid, filled by the monitor */
    vtpu_device_memory_t used[VTPU_MAX_DEVICES];
    uint64_t monitor_used[VTPU_MAX_DEVICES]; /* monitor-observed bytes */
    int32_t  status;   /* 1 = active */
    int32_t  _pad;
} vtpu_proc_slot_t;

typedef struct {
    uint32_t magic;
    uint32_t version;
    /* advisory lock word (futex-style; 0 free / pid holder) */
    uint32_t sem;
    uint32_t init_done;

    uint64_t num_devices;
    uint64_t limit[VTPU_MAX_DEVICES];     /* HBM cap, bytes; 0 = unlimited */
    uint64_t sm_limit[VTPU_MAX_DEVICES];  /* duty-cycle cap, percent */

    vtpu_proc_slot_t procs[VTPU_MAX_PROCS];

    /* feedback cells (monitor writes, shim reads) */
    int64_t  last_kernel_time;   /* unix seconds of last execute */
    int32_t  utilization_switch; /* >0: throttling enabled by monitor */
    int32_t  recent_kernel;      /* -1: blocked; >=0: run permitted */
    int32_t  priority;           /* task priority (0 high / 1 low) */
    int32_t  oversubscribe;      /* 1: host-RAM spill allowed */

    /* v2: the shared duty-cycle token bucket (under the sem lock) —
     * per-process buckets would give N sharers N x sm_limit */
    int64_t  duty_tokens_us[VTPU_MAX_DEVICES];
    uint64_t duty_refill_us[VTPU_MAX_DEVICES]; /* CLOCK_MONOTONIC us */
} vtpu_shared_region_t;

/* ---- region lifecycle ---- */

/* open (create+init if absent) the cache file and mmap it */
vtpu_shared_region_t *vtpu_shm_open(const char *path);
int  vtpu_shm_close(vtpu_shared_region_t *r);
void vtpu_shm_lock(vtpu_shared_region_t *r);
void vtpu_shm_unlock(vtpu_shared_region_t *r);

/* ---- per-process registration ---- */
int vtpu_proc_attach(vtpu_shared_region_t *r, int32_t pid); /* slot idx */
void vtpu_proc_detach(vtpu_shared_region_t *r, int32_t pid);

/* ---- HBM accounting / enforcement ----
 * returns 0 on success, -1 if the allocation would exceed limit[dev]
 * (the OOM-at-alloc-time semantics fractional sharing needs). */
int vtpu_try_alloc(vtpu_shared_region_t *r, int slot, int dev,
                   uint64_t bytes, int kind);
/* unconditional accounting for memory that already materialized on the
 * device (e.g. executable outputs): records usage without enforcing the
 * cap; returns 1 if the device is now over its limit, else 0. */
int vtpu_account(vtpu_shared_region_t *r, int slot, int dev,
                 uint64_t bytes, int kind);
void vtpu_free(vtpu_shared_region_t *r, int slot, int dev,
               uint64_t bytes, int kind);
/* total bytes used on dev across all processes */
uint64_t vtpu_device_used(const vtpu_shared_region_t *r, int dev);

/* ---- duty-cycle token bucket (shared across all region sharers) ----
 * Called before each executable launch; sleeps until the launch may run
 * under sm_limit[dev] percent duty cycle and the monitor's feedback cells.
 * cost_us is the estimated device-time of the launch. Returns the ns it
 * slept, from its first sleep to the grant (0 when it granted at once,
 * which reads no clock for it), and sets *kinds (when not NULL) to the
 * VTPU_WAIT_* bits of what it slept for. (lib/tpu's returns nothing.) */
#define VTPU_WAIT_BUCKET 1u /* too few tokens in the bucket */
#define VTPU_WAIT_BLOCK  2u /* the monitor's priority block */
uint64_t vtpu_rate_limit(vtpu_shared_region_t *r, int dev, uint64_t cost_us,
                         uint32_t *kinds);

/* the bucket's capacity (us of device time): its burst, and the largest
 * cost one vtpu_rate_limit call can ever be granted */
#define VTPU_DUTY_BUCKET_CAP_US 200000

/* test/metrics helper: tokens currently available (us) */
int64_t vtpu_rate_tokens(const vtpu_shared_region_t *r, int dev);

#ifdef __cplusplus
}
#endif

#endif /* VTPU_SHM_H */
