// Parallel shard I/O engine for BlockArray persistence.
//
// Role: the native half of checkpoint read and write. The .npy-per-block
// layout is written and read by a C++ thread pool with the GIL released
// (ctypes), so block I/O is bound by the disks, not by the interpreter.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC shard_io.cpp
//        -o libnums_shard_<hash>.so -lpthread
// (done at first use by nums_tpu_torch/core/io/shard_native.py and cached).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

int write_all(int fd, const unsigned char* buf, long len) {
    long done = 0;
    while (done < len) {
        ssize_t w = ::write(fd, buf + done, (size_t)(len - done));
        if (w < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        done += w;
    }
    return 0;
}

int pread_all(int fd, unsigned char* buf, long len, long off) {
    long done = 0;
    while (done < len) {
        ssize_t r = ::pread(fd, buf + done, (size_t)(len - done), off + done);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        if (r == 0) return -1;  // unexpected EOF
        done += r;
    }
    return 0;
}

template <typename Fn>
long run_pool(long n, int threads, Fn&& body) {
    if (threads < 1) threads = 1;
    if (threads > n) threads = (int)n;
    std::atomic<long> next(0);
    std::atomic<long> failures(0);
    auto worker = [&]() {
        for (;;) {
            long i = next.fetch_add(1);
            if (i >= n) return;
            if (body(i) != 0) failures.fetch_add(1);
        }
    };
    if (threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(threads);
        for (int t = 0; t < threads; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return failures.load() == 0 ? 0 : -1;
}

}  // namespace

extern "C" {

// Write n shard files in parallel: each gets header[i] (hlens[i] bytes,
// the .npy preamble built in Python) followed by datas[i] (dlens[i]
// bytes of raw array data). Returns 0 on success, -1 if any file failed.
long nums_write_shards(const char** paths, const unsigned char** headers,
                       const long* hlens, const unsigned char** datas,
                       const long* dlens, long n, int threads) {
    return run_pool(n, threads, [&](long i) -> int {
        int fd = ::open(paths[i], O_WRONLY | O_CREAT | O_TRUNC, 0644);
        if (fd < 0) return -1;
        int rc = write_all(fd, headers[i], hlens[i]);
        if (rc == 0 && dlens[i] > 0) rc = write_all(fd, datas[i], dlens[i]);
        ::close(fd);
        return rc;
    });
}

// Parallel strided region reads: job i preads n_rows[i] runs of
// row_bytes[i] from paths[i], source offsets src_off[i] + r*src_stride[i],
// into dsts[i] + r*dst_stride[i]. Handles the 1-D/2-D .npy block-window
// reads of the sharding-aware restore; each job is one (block, shard
// region) intersection. Returns 0 on success, -1 if any job failed.
long nums_read_regions(const char** paths, const long* src_off,
                       const long* row_bytes, const long* n_rows,
                       const long* src_stride, unsigned char** dsts,
                       const long* dst_stride, long n, int threads) {
    return run_pool(n, threads, [&](long i) -> int {
        int fd = ::open(paths[i], O_RDONLY);
        if (fd < 0) return -1;
        int rc = 0;
        for (long r = 0; r < n_rows[i] && rc == 0; r++) {
            rc = pread_all(fd, dsts[i] + r * dst_stride[i], row_bytes[i],
                           src_off[i] + r * src_stride[i]);
        }
        ::close(fd);
        return rc;
    });
}

}  // extern "C"
