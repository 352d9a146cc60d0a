// recordio: the host-side record I/O of tamcmc_tpu_torch.
//
// The asynchronous sample writer and the ASCII spectrum reader behind
// tamcmc_tpu_torch/io/native.py, with the C ABI and the semantics of the JAX
// package's native/recordio.cpp (its own copy: the port loads no library of
// that package).  The sampler streams each chunk's thinned cold-rung records
// from the card to the host; a double buffer with a background thread takes
// the fwrite off the sampling thread, and `rw_flush` is the synchronous
// barrier that a mid-phase checkpoint waits on.
//
// Host code: built with g++ (-O3 -std=c++17 -shared -fPIC -pthread) at first
// use by tamcmc_tpu_torch/ops/_cuda_build.py, loaded with ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Writer {
    FILE* f = nullptr;
    int nvars = 0;
    std::vector<double> buf[2];     // the double buffer
    int active = 0;                  // the buffer being filled
    std::atomic<long> nrecords{0};
    std::thread flusher;
    std::mutex m;
    std::condition_variable cv_work, cv_done;
    bool pending = false;            // the other buffer awaits its write
    bool stop = false;
    std::atomic<int> err{0};

    void write_out(std::vector<double>& b) {
        if (!b.empty() &&
            fwrite(b.data(), sizeof(double), b.size(), f) != b.size())
            err = 1;
        b.clear();
    }

    void flush_loop() {
        std::unique_lock<std::mutex> lk(m);
        for (;;) {
            cv_work.wait(lk, [&] { return pending || stop; });
            if (pending) {
                std::vector<double>& b = buf[1 - active];
                lk.unlock();
                write_out(b);
                lk.lock();
                pending = false;
                cv_done.notify_all();
            }
            if (stop && !pending) return;
        }
    }
};

}  // namespace

extern "C" {

// ---------------- buffered record writer ----------------

// Open `path` for writing (truncated) with records of `nvars` doubles;
// nullptr if the file cannot be opened.
void* rw_open(const char* path, int nvars) {
    Writer* w = new Writer();
    w->f = fopen(path, "wb");
    if (!w->f) { delete w; return nullptr; }
    w->nvars = nvars;
    w->flusher = std::thread([w] { w->flush_loop(); });
    return w;
}

// Append `nrec` records of w->nvars doubles: copy them into the active
// buffer and hand it to the background thread once it has written the other
// one.  Non-zero if a write has failed.
int rw_append(void* h, const double* data, long nrec) {
    Writer* w = static_cast<Writer*>(h);
    if (!w || w->err) return 1;
    size_t n = static_cast<size_t>(nrec) * w->nvars;
    {
        std::unique_lock<std::mutex> lk(w->m);
        std::vector<double>& b = w->buf[w->active];
        b.insert(b.end(), data, data + n);
        w->cv_done.wait(lk, [&] { return !w->pending; });
        w->active = 1 - w->active;
        w->pending = true;
        w->cv_work.notify_one();
    }
    w->nrecords += nrec;
    return w->err;
}

long rw_count(void* h) {
    Writer* w = static_cast<Writer*>(h);
    return w ? w->nrecords.load() : -1;
}

// Synchronous barrier: returns once every appended record is in the file
// (the kernel's page cache).  A mid-phase checkpoint waits on it: the .bin
// must hold at least the records the restore file claims, or a resume after
// a kill would truncate into records the checkpoint depends on.
int rw_flush(void* h) {
    Writer* w = static_cast<Writer*>(h);
    if (!w) return 1;
    std::unique_lock<std::mutex> lk(w->m);
    w->cv_done.wait(lk, [&] { return !w->pending; });   // the handed buffer
    w->write_out(w->buf[w->active]);                     // the active one
    if (fflush(w->f) != 0) w->err = 1;
    return w->err;
}

// Write what is left, stop the thread, close the file, free the writer.
int rw_close(void* h) {
    Writer* w = static_cast<Writer*>(h);
    if (!w) return 1;
    {
        std::unique_lock<std::mutex> lk(w->m);
        w->cv_done.wait(lk, [&] { return !w->pending; });
        w->write_out(w->buf[w->active]);
        w->stop = true;
        w->cv_work.notify_one();
    }
    w->flusher.join();
    int err = w->err | (fclose(w->f) != 0);
    delete w;
    return err;
}

// ---------------- ASCII table reader ----------------

// Parse a whitespace-separated numeric table with strtod, skipping blank
// lines and comment lines that start with '#', '!' or '*'.  Fills out[]
// (cap doubles, caller-allocated) row-major with *ncols columns, the count
// of the first data row.  Returns the rows parsed, -1 if the file cannot be
// opened, -2 for a ragged table, -3 if it holds more than cap values.
long ascii_read_table(const char* path, double* out, long cap, int* ncols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long n = 0;
    int cols = 0;
    char buf[1 << 16];
    while (fgets(buf, sizeof buf, f)) {
        char* p = buf;
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '#' || *p == '!' || *p == '*' || *p == '\n' || *p == '\0')
            continue;
        int c = 0;
        char* end = p;
        while (true) {
            double v = strtod(p, &end);
            if (end == p) break;
            if (n + c < cap) out[n + c] = v;
            ++c;
            p = end;
        }
        if (c == 0) continue;
        if (cols == 0) cols = c;
        if (c != cols) { fclose(f); return -2; }
        n += cols;
        if (n > cap) { fclose(f); return -3; }
    }
    fclose(f);
    *ncols = cols;
    return cols ? n / cols : 0;
}

}  // extern "C"
