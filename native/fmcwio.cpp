// fmcwio — native IO/runtime support for the radar framework.
//
// The reference framework's "native" layer is its VHDL datapath + testbench
// textio writers (SURVEY.md §2); this library is the framework's host-side
// native counterpart: fast parsers for the reference text formats (the Python
// loops are ~30x slower on 131k-line frame files) and a blocking SPSC frame
// ring buffer used by the streaming runtime to overlap host-side frame
// synthesis/ingest with device compute (the ping-pong ingest analog of
// rtl/src/corner_turner.vhd:31-36).
//
// Exposed as a plain C ABI consumed via ctypes (fmcw_tpu/runtime/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Parse a whitespace-separated integer text file with `cols` columns per
// line into `out` (int32), up to `cap` values.  Returns the number of values
// written, or -1 on open failure.  Handles the "I Q" chirp files, the
// "r d 0 0 mag" map files and "r d mag" detection logs uniformly.
long fmcwio_parse_ints(const char* path, int32_t* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // Read whole file.  A non-seekable path (FIFO, /dev/stdin) makes ftell
  // return -1; treat it as an open failure instead of sizing a zero-byte
  // buffer and fread'ing (size_t)-1 bytes into it.
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
  long sz = ftell(f);
  if (sz < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -1; }
  std::vector<char> buf((size_t)sz + 1);
  size_t rd = fread(buf.data(), 1, (size_t)sz, f);
  fclose(f);
  buf[rd] = '\0';

  long n = 0;
  const char* p = buf.data();
  const char* end = p + rd;
  while (p < end && n < cap) {
    // Skip non-numeric separators.
    while (p < end && !((*p >= '0' && *p <= '9') || *p == '-' || *p == '+'))
      ++p;
    if (p >= end) break;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    else if (*p == '+') { ++p; }
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    out[n++] = (int32_t)(neg ? -v : v);
  }
  return n;
}

// Write a full magnitude map in the golden v3 monitor format
// ("r d 0 0 mag" per line, Doppler-fast — rtl/old/tb_radar_core.vhd:173-208).
// Returns 0 on success.
int fmcwio_write_rdm(const char* path, const int32_t* mag, int n_range,
                     int n_doppler) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> iobuf(1 << 20);
  setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
  // Propagate write failures (ENOSPC, I/O errors) — fclose also flushes
  // the stream buffer, so its status must be checked too, or a truncated
  // map would be reported as a success.
  bool ok = true;
  for (int r = 0; r < n_range && ok; ++r)
    for (int d = 0; d < n_doppler; ++d)
      if (fprintf(f, "%d %d 0 0 %d\n", r, d,
                  mag[(long)r * n_doppler + d]) < 0) { ok = false; break; }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Blocking SPSC ring buffer of fixed-size frames.
// ---------------------------------------------------------------------------

struct FrameRing {
  std::vector<int16_t> data;
  long frame_elems;
  int capacity;
  int head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
};

void* fmcwio_ring_create(long frame_elems, int capacity) {
  FrameRing* r = new FrameRing();
  r->frame_elems = frame_elems;
  r->capacity = capacity;
  r->data.resize((size_t)frame_elems * capacity);
  return r;
}

void fmcwio_ring_destroy(void* ring) { delete (FrameRing*)ring; }

// Push a frame; blocks while full.  Returns 0, or -1 if the ring was closed.
int fmcwio_ring_push(void* ring, const int16_t* frame) {
  FrameRing* r = (FrameRing*)ring;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_push.wait(lk, [&] { return r->count < r->capacity || r->closed; });
  if (r->closed) return -1;
  memcpy(&r->data[(size_t)r->head * r->frame_elems], frame,
         r->frame_elems * sizeof(int16_t));
  r->head = (r->head + 1) % r->capacity;
  ++r->count;
  r->cv_pop.notify_one();
  return 0;
}

// Try to push without blocking.  Returns 1 on success, 0 if full (caller
// counts the drop — the overflow_error analog), -1 if closed.
int fmcwio_ring_try_push(void* ring, const int16_t* frame) {
  FrameRing* r = (FrameRing*)ring;
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->closed) return -1;
  if (r->count >= r->capacity) return 0;
  memcpy(&r->data[(size_t)r->head * r->frame_elems], frame,
         r->frame_elems * sizeof(int16_t));
  r->head = (r->head + 1) % r->capacity;
  ++r->count;
  r->cv_pop.notify_one();
  return 1;
}

// Pop a frame; blocks while empty.  Returns 0, or -1 if closed and drained.
int fmcwio_ring_pop(void* ring, int16_t* frame_out) {
  FrameRing* r = (FrameRing*)ring;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_pop.wait(lk, [&] { return r->count > 0 || r->closed; });
  if (r->count == 0) return -1;
  memcpy(frame_out, &r->data[(size_t)r->tail * r->frame_elems],
         r->frame_elems * sizeof(int16_t));
  r->tail = (r->tail + 1) % r->capacity;
  --r->count;
  r->cv_push.notify_one();
  return 0;
}

void fmcwio_ring_close(void* ring) {
  FrameRing* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  r->closed = true;
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
}

int fmcwio_ring_size(void* ring) {
  FrameRing* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  return r->count;
}

// ---------------------------------------------------------------------------
// Threaded file streamer: the framework's data loader.  A native producer
// thread reads fixed-size int16 frames from a raw binary file and pushes
// them into a FrameRing, entirely outside the Python GIL, so host-side IO
// overlaps both frame preprocessing and device compute (the ADC front-end
// analog of the reference's streaming s_axis ingest, radar_core.vhd:26-29).
// ---------------------------------------------------------------------------

struct StreamJob {
  std::thread th;
  long pushed = 0;
  int error = 0;  // 0 ok; 1 open failure; 2 ring closed early
};

// Start streaming `loops` passes over `path` (raw little-endian int16,
// frame_elems values per frame; a trailing partial frame is ignored) into
// the ring.  When all passes complete (or the ring is closed from the
// consumer side) the ring is closed so the consumer's pop() drains and
// returns end-of-stream.  Returns a job handle for fmcwio_stream_join.
void* fmcwio_stream_file(void* ring, const char* path, int loops) {
  FrameRing* r = (FrameRing*)ring;
  StreamJob* job = new StreamJob();
  std::string p(path);
  job->th = std::thread([r, p, loops, job] {
    std::vector<int16_t> frame(r->frame_elems);
    for (int l = 0; l < loops && !job->error; ++l) {
      FILE* f = fopen(p.c_str(), "rb");
      if (!f) { job->error = 1; break; }
      while (fread(frame.data(), sizeof(int16_t), r->frame_elems, f)
             == (size_t)r->frame_elems) {
        if (fmcwio_ring_push(r, frame.data()) != 0) { job->error = 2; break; }
        ++job->pushed;
      }
      fclose(f);
    }
    {
      std::lock_guard<std::mutex> lk(r->mu);
      r->closed = true;
    }
    r->cv_push.notify_all();
    r->cv_pop.notify_all();
  });
  return job;
}

// Join the streamer thread.  Returns frames pushed; -1 if the file could
// not be opened.  (A consumer-side ring close simply ends the stream and
// reports the frames delivered up to that point.)
long fmcwio_stream_join(void* handle) {
  StreamJob* job = (StreamJob*)handle;
  if (job->th.joinable()) job->th.join();
  long out = job->error == 1 ? -1 : job->pushed;
  delete job;
  return out;
}

}  // extern "C"
