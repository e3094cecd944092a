/*
 * The port's copy of lib/tpu/vtpu_shm.c. Shared-region implementation: mmap
 * lifecycle, cross-process accounting, and the duty-cycle token bucket.
 *
 * Enforcement semantics (SURVEY.md §7 hard-part #1/#2): HBM checks happen
 * at allocation time against the *sum across processes* sharing the chip,
 * so a 4-way split of a 16 GiB chip can never overcommit; the duty-cycle
 * bucket refills at sm_limit percent of wall time and is drained by
 * executable launches, mirroring HAMi-core's recentKernel/utilizationSwitch
 * design (reference cmd/vGPUmonitor/feedback.go:197-255).
 */

#define _GNU_SOURCE
#include "vtpu_shm.h"

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

static uint64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

static uint64_t now_us(void) {
    return now_ns() / 1000ull;
}

vtpu_shared_region_t *vtpu_shm_open(const char *path) {
    int fd = open(path, O_RDWR | O_CREAT, 0666);
    if (fd < 0) {
        return NULL;
    }
    /* size + init exactly once across racing openers */
    struct flock fl = {.l_type = F_WRLCK, .l_whence = SEEK_SET};
    fcntl(fd, F_SETLKW, &fl);
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return NULL;
    }
    int undersized = st.st_size < (off_t)sizeof(vtpu_shared_region_t);
    if (undersized && ftruncate(fd, sizeof(vtpu_shared_region_t)) != 0) {
        close(fd);
        return NULL;
    }
    vtpu_shared_region_t *r = mmap(NULL, sizeof(*r), PROT_READ | PROT_WRITE,
                                   MAP_SHARED, fd, 0);
    if (r == MAP_FAILED) {
        close(fd);
        return NULL;
    }
    int empty = st.st_size == 0;
    if (empty || r->magic != VTPU_SHM_MAGIC) {
        memset(r, 0, sizeof(*r));
        r->magic = VTPU_SHM_MAGIC;
        r->version = VTPU_SHM_VERSION;
        r->recent_kernel = 1;
        r->init_done = 1;
    } else if (undersized) {
        /* live v1 region zero-extended in place: v1 writers keep their
         * smaller mapping and state; the appended fields arrive zeroed
         * (the bucket initializes lazily), so just stamp the version
         * instead of wiping their accounting */
        r->version = VTPU_SHM_VERSION;
    }
    fl.l_type = F_UNLCK;
    fcntl(fd, F_SETLK, &fl);
    close(fd); /* mapping survives */
    return r;
}

int vtpu_shm_close(vtpu_shared_region_t *r) {
    return munmap(r, sizeof(*r));
}

/* Forced-break backstop. Critical sections are microseconds, but a live
 * holder can stall arbitrarily (SIGSTOP, cgroup freeze, a GC pause in a
 * Python holder), so the backstop must be far beyond any plausible stall:
 * at 30s a break almost certainly means the holder died with its pid
 * recycled (which defeats the kill(pid, 0) probe). Losing 30s on that
 * rare path costs nothing; breaking a live holder's lock corrupts
 * slot/feedback state. */
#define VTPU_LOCK_BREAK_US 30000000ull

/* Holders outside the contender's pid namespace (the host-side monitor
 * locking a container's region) set this bit in the sem word: kill(pid, 0)
 * on a foreign-namespace pid returns ESRCH even when the holder is alive,
 * so contenders skip the probe for such holders and rely only on the
 * wall-clock backstop. pid_max caps at 2^22, so bit 31 is never a pid bit. */
#define VTPU_SEM_NO_PROBE 0x80000000u

static uint32_t sem_self(void) {
    static int no_probe = -1;
    if (no_probe < 0) {
        no_probe = getenv("VTPU_SHM_NO_PID_PROBE") != NULL;
    }
    uint32_t self = (uint32_t)getpid();
    return no_probe ? (self | VTPU_SEM_NO_PROBE) : self;
}

void vtpu_shm_lock(vtpu_shared_region_t *r) {
    /* sem holds 0 (free) or the holder's pid (| VTPU_SEM_NO_PROBE for
     * cross-namespace holders). A holder SIGKILLed inside a critical
     * section (kernel OOM, VTPU_ACTIVE_OOM_KILLER) must not wedge every
     * sharer of the chip: spinners periodically probe the recorded holder
     * with kill(pid, 0) and break the lock once it is gone, with a
     * wall-clock forced break as the pid-reuse / cross-namespace backstop. */
    uint32_t self = sem_self();
    int probe_ok = (self & VTPU_SEM_NO_PROBE) == 0;
    int spins = 0;
    uint64_t wait_start = 0;
    for (;;) {
        if (__sync_bool_compare_and_swap(&r->sem, 0u, self)) {
            return;
        }
        uint32_t cur = r->sem;
        if (++spins >= 50) { /* every ~10ms of spinning, probe the holder */
            spins = 0;
            uint64_t now = now_us();
            if (wait_start == 0) {
                wait_start = now;
            }
            /* never probe a no-probe holder: its pid is from another
             * namespace and ESRCH there says nothing about liveness */
            int dead = probe_ok && cur != 0 &&
                       !(cur & VTPU_SEM_NO_PROBE) &&
                       kill((pid_t)cur, 0) != 0 && errno == ESRCH;
            if (dead || (cur != 0 && now - wait_start > VTPU_LOCK_BREAK_US)) {
                __sync_bool_compare_and_swap(&r->sem, cur, 0u);
                continue;
            }
        }
        struct timespec ts = {0, 200000}; /* 200us */
        nanosleep(&ts, NULL);
    }
}

void vtpu_shm_unlock(vtpu_shared_region_t *r) {
    /* release only if we still own it: after a stale-break our ownership
     * may have moved on, and a blind store would zero someone else's lock */
    __sync_bool_compare_and_swap(&r->sem, sem_self(), 0u);
}

int vtpu_proc_attach(vtpu_shared_region_t *r, int32_t pid) {
    vtpu_shm_lock(r);
    int slot = -1;
    for (int i = 0; i < VTPU_MAX_PROCS; i++) {
        if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
            slot = i; /* re-attach */
            break;
        }
        if (slot < 0 && r->procs[i].status == 0) {
            slot = i;
        }
    }
    if (slot >= 0 && !(r->procs[slot].status == 1 &&
                       r->procs[slot].pid == pid)) {
        memset(&r->procs[slot], 0, sizeof(r->procs[slot]));
        r->procs[slot].pid = pid;
        r->procs[slot].status = 1;
    }
    vtpu_shm_unlock(r);
    return slot;
}

void vtpu_proc_detach(vtpu_shared_region_t *r, int32_t pid) {
    vtpu_shm_lock(r);
    for (int i = 0; i < VTPU_MAX_PROCS; i++) {
        if (r->procs[i].status == 1 && r->procs[i].pid == pid) {
            memset(&r->procs[i], 0, sizeof(r->procs[i]));
        }
    }
    vtpu_shm_unlock(r);
}

uint64_t vtpu_device_used(const vtpu_shared_region_t *r, int dev) {
    uint64_t used = 0;
    for (int i = 0; i < VTPU_MAX_PROCS; i++) {
        if (r->procs[i].status == 1) {
            used += r->procs[i].used[dev].total;
        }
    }
    return used;
}

int vtpu_try_alloc(vtpu_shared_region_t *r, int slot, int dev,
                   uint64_t bytes, int kind) {
    if (slot < 0 || slot >= VTPU_MAX_PROCS || dev < 0 ||
        dev >= VTPU_MAX_DEVICES || kind < 0 || kind >= VTPU_MEM_KINDS) {
        return -1;
    }
    int rc = 0;
    vtpu_shm_lock(r);
    uint64_t limit = r->limit[dev];
    if (limit != 0 && !r->oversubscribe &&
        vtpu_device_used(r, dev) + bytes > limit) {
        rc = -1; /* hard OOM at allocation time */
    } else {
        r->procs[slot].used[dev].kinds[kind] += bytes;
        r->procs[slot].used[dev].total += bytes;
    }
    vtpu_shm_unlock(r);
    return rc;
}

int vtpu_account(vtpu_shared_region_t *r, int slot, int dev,
                 uint64_t bytes, int kind) {
    if (slot < 0 || slot >= VTPU_MAX_PROCS || dev < 0 ||
        dev >= VTPU_MAX_DEVICES || kind < 0 || kind >= VTPU_MEM_KINDS) {
        return 0;
    }
    vtpu_shm_lock(r);
    r->procs[slot].used[dev].kinds[kind] += bytes;
    r->procs[slot].used[dev].total += bytes;
    uint64_t limit = r->limit[dev];
    int over = limit != 0 && !r->oversubscribe &&
               vtpu_device_used(r, dev) > limit;
    vtpu_shm_unlock(r);
    return over;
}

void vtpu_free(vtpu_shared_region_t *r, int slot, int dev,
               uint64_t bytes, int kind) {
    if (slot < 0 || slot >= VTPU_MAX_PROCS || dev < 0 ||
        dev >= VTPU_MAX_DEVICES || kind < 0 || kind >= VTPU_MEM_KINDS) {
        return;
    }
    vtpu_shm_lock(r);
    vtpu_device_memory_t *m = &r->procs[slot].used[dev];
    m->kinds[kind] -= (bytes > m->kinds[kind]) ? m->kinds[kind] : bytes;
    m->total -= (bytes > m->total) ? m->total : bytes;
    vtpu_shm_unlock(r);
}

/* ---- duty-cycle token bucket ----
 * State lives IN the shared region (v2), so every process sharing the
 * slice drains one bucket and the combined duty cycle honors sm_limit —
 * per-process buckets would give N sharers N x the budget. Mutations run
 * under the region sem lock; sleeping happens outside it. */

static const int64_t BUCKET_CAP_US = VTPU_DUTY_BUCKET_CAP_US;

int64_t vtpu_rate_tokens(const vtpu_shared_region_t *r, int dev) {
    if (dev < 0 || dev >= VTPU_MAX_DEVICES) {
        return 0;
    }
    return r->duty_tokens_us[dev];
}

uint64_t vtpu_rate_limit(vtpu_shared_region_t *r, int dev, uint64_t cost_us,
                         uint32_t *kinds) {
    uint32_t waited = 0;
    uint64_t asleep = 0; /* CLOCK_MONOTONIC ns at the first sleep */
    if (kinds) {
        *kinds = 0;
    }
    if (dev < 0 || dev >= VTPU_MAX_DEVICES) {
        return 0;
    }
    for (;;) {
        /* monitor hard-block (priority arbitration) — checked before the
         * duty-cycle gate and INDEPENDENT of it: an uncapped container
         * must still freeze when the monitor parks it behind a
         * higher-priority task (reference feedback.go:197-255 arbitrates
         * regardless of the SM limit) */
        if (r->recent_kernel < 0 && r->utilization_switch > 0) {
            if (!waited) {
                asleep = now_ns();
            }
            waited |= VTPU_WAIT_BLOCK;
            struct timespec ts = {0, 2000000}; /* 2ms */
            nanosleep(&ts, NULL);
            continue;
        }
        uint64_t pct = r->sm_limit[dev];
        if (pct == 0 || pct >= 100) {
            r->last_kernel_time = (int64_t)time(NULL);
            break; /* no duty-cycle cap (hard-block already honored) */
        }
        int64_t tokens;
        vtpu_shm_lock(r);
        uint64_t now = now_us();
        if (r->duty_refill_us[dev] == 0 || r->duty_refill_us[dev] > now) {
            /* first use, or a stale CLOCK_MONOTONIC stamp from before a
             * reboot (cache files can outlive the boot): reset instead of
             * letting `now - refill` underflow into a garbage refill */
            r->duty_refill_us[dev] = now;
            r->duty_tokens_us[dev] = BUCKET_CAP_US;
        }
        uint64_t elapsed = now - r->duty_refill_us[dev];
        r->duty_refill_us[dev] = now;
        tokens = r->duty_tokens_us[dev] + (int64_t)(elapsed * pct / 100ull);
        if (tokens > BUCKET_CAP_US) {
            tokens = BUCKET_CAP_US;
        }
        int granted = tokens >= (int64_t)cost_us;
        if (granted) {
            tokens -= (int64_t)cost_us;
        }
        r->duty_tokens_us[dev] = tokens;
        vtpu_shm_unlock(r);
        if (granted) {
            r->last_kernel_time = (int64_t)time(NULL);
            break;
        }
        if (!waited) {
            asleep = now_ns();
        }
        waited |= VTPU_WAIT_BUCKET;
        /* sleep until enough tokens accrue */
        uint64_t need = (uint64_t)((int64_t)cost_us - tokens);
        uint64_t wait = need * 100ull / pct;
        if (wait > 50000ull) {
            wait = 50000ull; /* re-check feedback every 50ms */
        }
        struct timespec ts = {(time_t)(wait / 1000000ull),
                              (long)((wait % 1000000ull) * 1000ull)};
        nanosleep(&ts, NULL);
    }
    if (kinds) {
        *kinds = waited;
    }
    return waited ? now_ns() - asleep : 0;
}
