// pyfft_tpu_torch native IO tier: memory-mapped streaming shot-file loader.
//
// Role: the framework's data-ingestion runtime (the reference delegates IO
// to h5py/NumPy on the Python heap; HeatPulse_Funcs.py:33-70).  Raw DAQ
// captures are interleaved channel frames; this library memory-maps the
// file and produces deinterleaved float32 channel blocks — with optional
// boxcar decimation fused into the copy — so the Python layer touches the
// data exactly once, as device-ready blocks for StreamingWelch.
//
// C ABI (ctypes-bound from pyfft_tpu_torch.io.loader):
//   shotloader_open(path, nch, dtype_code, header_bytes) -> handle | NULL
//   shotloader_nsamples(handle) -> per-channel sample count
//   shotloader_read(handle, start, count, decim, out) -> samples written
//   shotloader_close(handle)
//
// dtype codes: 0 = int16, 1 = float32, 2 = float64 (little-endian).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Shot {
    int fd = -1;
    const uint8_t* base = nullptr;   // mmap base
    size_t map_len = 0;
    const uint8_t* data = nullptr;   // past header
    long nch = 0;
    int dtype = 0;                   // 0 i16, 1 f32, 2 f64
    long nsamples = 0;               // per channel
};

size_t dtype_size(int code) {
    switch (code) {
        case 0: return 2;
        case 1: return 4;
        case 2: return 8;
        default: return 0;
    }
}

// Deinterleave + convert + (optionally) boxcar-decimate one channel.
// src points at the first frame of the requested range.
template <typename T>
void copy_channel(const T* src, long nch, long ch, long count, long decim,
                  float* out) {
    if (decim <= 1) {
        for (long i = 0; i < count; ++i) {
            out[i] = static_cast<float>(src[i * nch + ch]);
        }
        return;
    }
    const long nout = count / decim;
    const float inv = 1.0f / static_cast<float>(decim);
    for (long o = 0; o < nout; ++o) {
        float acc = 0.0f;
        const T* frame = src + (o * decim) * nch + ch;
        for (long j = 0; j < decim; ++j) {
            acc += static_cast<float>(frame[j * nch]);
        }
        out[o] = acc * inv;
    }
}

}  // namespace

extern "C" {

void* shotloader_open(const char* path, long nch, int dtype_code,
                      long header_bytes) {
    if (nch <= 0 || dtype_size(dtype_code) == 0 || header_bytes < 0) {
        return nullptr;
    }
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (::fstat(fd, &st) != 0 || st.st_size < header_bytes) {
        ::close(fd);
        return nullptr;
    }
    void* base = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                        MAP_PRIVATE, fd, 0);
    if (base == MAP_FAILED) {
        ::close(fd);
        return nullptr;
    }
    ::madvise(base, static_cast<size_t>(st.st_size), MADV_SEQUENTIAL);

    Shot* s = new Shot();
    s->fd = fd;
    s->base = static_cast<const uint8_t*>(base);
    s->map_len = static_cast<size_t>(st.st_size);
    s->data = s->base + header_bytes;
    s->nch = nch;
    s->dtype = dtype_code;
    const size_t frame = dtype_size(dtype_code) * static_cast<size_t>(nch);
    s->nsamples = static_cast<long>(
        (static_cast<size_t>(st.st_size) - header_bytes) / frame);
    return s;
}

long shotloader_nsamples(void* handle) {
    return handle ? static_cast<Shot*>(handle)->nsamples : -1;
}

long shotloader_nch(void* handle) {
    return handle ? static_cast<Shot*>(handle)->nch : -1;
}

// Read `count` per-channel samples starting at frame `start`, decimating
// by `decim` (boxcar mean).  `out` is (nch, count/decim) row-major float32.
// Returns per-channel samples written, or -1 on error.
long shotloader_read(void* handle, long start, long count, long decim,
                     float* out) {
    Shot* s = static_cast<Shot*>(handle);
    if (!s || start < 0 || count < 0 || decim < 1) return -1;
    if (start + count > s->nsamples) count = s->nsamples - start;
    if (count < 0) return -1;
    count -= count % decim;          // whole decimation groups only
    const long nout = count / decim;

    const size_t esz = dtype_size(s->dtype);
    const uint8_t* src = s->data + esz * static_cast<size_t>(start) *
                                       static_cast<size_t>(s->nch);
    for (long ch = 0; ch < s->nch; ++ch) {
        float* dst = out + ch * nout;
        switch (s->dtype) {
            case 0:
                copy_channel(reinterpret_cast<const int16_t*>(src), s->nch,
                             ch, count, decim, dst);
                break;
            case 1:
                copy_channel(reinterpret_cast<const float*>(src), s->nch,
                             ch, count, decim, dst);
                break;
            case 2:
                copy_channel(reinterpret_cast<const double*>(src), s->nch,
                             ch, count, decim, dst);
                break;
        }
    }
    return nout;
}

void shotloader_close(void* handle) {
    Shot* s = static_cast<Shot*>(handle);
    if (!s) return;
    if (s->base) ::munmap(const_cast<uint8_t*>(s->base), s->map_len);
    if (s->fd >= 0) ::close(s->fd);
    delete s;
}

}  // extern "C"

// --------------------------------------------------------------------------
// Async prefetch pipeline: a producer thread deinterleaves/decimates blocks
// ahead of the consumer into a ring of buffers, so page-fault + convert
// latency overlaps the consumer's (device) work — the IO half of the
// double-buffered runtime, mirroring what the Pallas grid pipeline does on
// the device side.  The consumer copies the ready slot out (memcpy-speed;
// the expensive deinterleave/convert already happened on the worker).
// --------------------------------------------------------------------------

#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Prefetcher {
    Shot* shot = nullptr;
    long block = 0;                  // input frames per block (decim-aligned)
    long decim = 1;
    long pos = 0;                    // next input frame to produce
    long end = 0;                    // one past the last input frame
    int nbuf = 0;
    std::vector<std::vector<float>> bufs;   // nbuf x (nch * block/decim)
    std::vector<long> counts;               // nout per filled slot
    long head = 0;                   // blocks produced
    long tail = 0;                   // blocks consumed
    bool done = false;
    bool stop = false;
    std::mutex mu;
    std::condition_variable cv;
    std::thread worker;
};

void prefetch_worker(Prefetcher* p) {
    for (;;) {
        {
            std::unique_lock<std::mutex> lk(p->mu);
            p->cv.wait(lk, [p] {
                return p->stop || p->head - p->tail < p->nbuf;
            });
            if (p->stop) break;
            if (p->pos >= p->end) {
                p->done = true;
                p->cv.notify_all();
                break;
            }
        }
        long count = p->block;
        if (p->pos + count > p->end) count = p->end - p->pos;
        count -= count % p->decim;
        const int slot = static_cast<int>(p->head % p->nbuf);
        long nout = 0;
        if (count > 0) {
            nout = shotloader_read(p->shot, p->pos, count, p->decim,
                                   p->bufs[slot].data());
        }
        {
            std::lock_guard<std::mutex> lk(p->mu);
            p->pos += count;
            if (nout <= 0 || count <= 0) {
                p->done = true;
            } else {
                p->counts[slot] = nout;
                ++p->head;
            }
            p->cv.notify_all();
            if (p->done) break;
        }
    }
}

}  // namespace

extern "C" {

// Start a background producer over frames [start, start + nframes) (pass
// nframes < 0 for "to the end of the file").  `block` input frames per
// slot, `nbuf` ring slots.  Returns a prefetcher handle or NULL.
void* shotloader_prefetch_start(void* handle, long start, long nframes,
                                long block, long decim, int nbuf) {
    Shot* s = static_cast<Shot*>(handle);
    if (!s || start < 0 || block < 1 || decim < 1 || nbuf < 2) return nullptr;
    block -= block % decim;
    if (block <= 0) return nullptr;
    Prefetcher* p = new Prefetcher();
    p->shot = s;
    p->block = block;
    p->decim = decim;
    p->pos = start;
    p->end = (nframes < 0) ? s->nsamples
                           : std::min(s->nsamples, start + nframes);
    p->nbuf = nbuf;
    const size_t slot_f = static_cast<size_t>(s->nch) *
                          static_cast<size_t>(block / decim);
    p->bufs.assign(nbuf, std::vector<float>(slot_f));
    p->counts.assign(nbuf, 0);
    p->worker = std::thread(prefetch_worker, p);
    return p;
}

// Blocks until the next block is ready; copies it into `out` ((nch, nout)
// row-major with the slot's nout) and returns nout.  Returns 0 at the end
// of the range, -1 on error.
long shotloader_prefetch_next(void* ph, float* out) {
    Prefetcher* p = static_cast<Prefetcher*>(ph);
    if (!p || !out) return -1;
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [p] { return p->tail < p->head || p->done || p->stop; });
    if (p->tail == p->head) return p->stop ? -1 : 0;
    const int slot = static_cast<int>(p->tail % p->nbuf);
    const long nout = p->counts[slot];
    const long nch = p->shot->nch;
    lk.unlock();                      // slot is exclusively ours until ++tail
    std::memcpy(out, p->bufs[slot].data(),
                sizeof(float) * static_cast<size_t>(nch) *
                    static_cast<size_t>(nout));
    lk.lock();
    ++p->tail;
    p->cv.notify_all();
    return nout;
}

void shotloader_prefetch_close(void* ph) {
    Prefetcher* p = static_cast<Prefetcher*>(ph);
    if (!p) return;
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->stop = true;
        p->cv.notify_all();
    }
    if (p->worker.joinable()) p->worker.join();
    delete p;
}

}  // extern "C"
