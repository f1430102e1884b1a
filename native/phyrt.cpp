// Native host runtime for the batched PHY framework.
//
// The reference's runtime substrate is GNU Radio's C++ scheduler with
// shared-memory ring buffers (SURVEY.md L0).  Here the GPU owns the DSP, and
// this library owns the host-side hot paths around it:
//
//   * an SPSC IQ ring buffer with overlap-save block reads (the ingest path
//     between an SDR/UDP source thread and the device batcher),
//   * a streaming STF plateau pre-detector (gates idle air time on the host
//     so only active sample blocks ship to the device),
//   * batched CRC32/FCS residue checks and the VHT A-MPDU delimiter walk
//     (per-packet MAC work that is python-slow at >10k pkt/s).
//
// Exposed as a plain C ABI consumed via ctypes (runtime/native.py).
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <complex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32 (IEEE 802.3 / FCS) — slice-by-8
// ---------------------------------------------------------------------------

static uint32_t crc_tab[8][256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (-(int32_t)(c & 1)));
    crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      crc_tab[s][i] = (crc_tab[s - 1][i] >> 8) ^ crc_tab[0][crc_tab[s - 1][i] & 0xFF];
  crc_init_done = true;
}

uint32_t phyrt_crc32(const uint8_t* data, int64_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    c ^= (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
         ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
    c = crc_tab[7][c & 0xFF] ^ crc_tab[6][(c >> 8) & 0xFF] ^
        crc_tab[5][(c >> 16) & 0xFF] ^ crc_tab[4][c >> 24] ^
        crc_tab[3][data[i + 4]] ^ crc_tab[2][data[i + 5]] ^
        crc_tab[1][data[i + 6]] ^ crc_tab[0][data[i + 7]];
  }
  for (; i < n; i++) c = (c >> 8) ^ crc_tab[0][(c ^ data[i]) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// FCS residue check over (frame || fcs): crc32 == 0x2144DF1C pre-final-xor
// convention -> with the table above, crc32(frame||fcs) == 0x2144DF1C.
int phyrt_fcs_ok(const uint8_t* frame, int64_t n) {
  if (n <= 4) return 0;
  return phyrt_crc32(frame, n) == 0x2144DF1Cu;
}

// Batched: frames (b, stride) with per-frame length len; ok[b] out.
void phyrt_fcs_ok_batch(const uint8_t* frames, int64_t b, int64_t stride,
                        int64_t len, uint8_t* ok) {
  for (int64_t i = 0; i < b; i++)
    ok[i] = (uint8_t)phyrt_fcs_ok(frames + i * stride, len);
}

// ---------------------------------------------------------------------------
// VHT A-MPDU delimiter walk (lib/decode_impl.cc:325-427 behavior)
// ---------------------------------------------------------------------------

static int crc8_delim(const uint8_t* d) {  // over first 16 bits, LSB-first
  uint8_t c = 0xFF;
  for (int byte = 0; byte < 2; byte++)
    for (int bit = 0; bit < 8; bit++) {
      int b = (d[byte] >> bit) & 1;
      int fb = ((c >> 7) & 1) ^ b;
      c = (uint8_t)((c << 1) ^ (fb ? 0x07 : 0));
    }
  // the crc byte on the wire carries register bit 7 first (LSB-first pack)
  uint8_t inv = (uint8_t)~c, out = 0;
  for (int i = 0; i < 8; i++) out |= ((inv >> (7 - i)) & 1) << i;
  return out;
}

// Returns number of FCS-valid MPDUs found; offsets/lens arrays sized max_out.
int phyrt_deagg_vht(const uint8_t* psdu, int64_t n, int32_t* offsets,
                    int32_t* lens, int max_out) {
  int found = 0;
  int64_t pos = 0;
  while (pos + 4 <= n && found < max_out) {
    const uint8_t* d = psdu + pos;
    if (d[3] != 0x4E || crc8_delim(d) != d[2]) { pos += 4; continue; }
    int len = ((d[0] >> 4) | (d[1] << 4)) & 0x0FFF;
    len |= ((d[0] >> 2) & 3) << 12;
    if (len == 0) { pos += 4; continue; }  // EOF padding subframe
    if (pos + 4 + len <= n && phyrt_fcs_ok(psdu + pos + 4, len)) {
      offsets[found] = (int32_t)(pos + 4);
      lens[found] = len;
      found++;
    }
    pos += 4 + len;
    pos += (4 - (pos & 3)) & 3;
  }
  return found;
}

// ---------------------------------------------------------------------------
// STF plateau pre-detector (float32 interleaved IQ)
// ---------------------------------------------------------------------------

// m[k] = |sum_{j<48} x[k+j] conj(x[k+16+j])| / sum_{j<64} |x[k+j]|^2
// Returns count of plateau starts (>= run consecutive above thresh).
int phyrt_stf_detect(const float* iq, int64_t n, float thresh, int run,
                     int32_t* out_idx, int max_out, int32_t min_spacing) {
  if (n < 96) return 0;
  int found = 0;
  double cr = 0, ci = 0, pw = 0;
  // rolling sums
  for (int j = 0; j < 48; j++) {
    float ar = iq[2 * j], ai = iq[2 * j + 1];
    float br = iq[2 * (j + 16)], bi = iq[2 * (j + 16) + 1];
    cr += (double)ar * br + (double)ai * bi;
    ci += (double)ai * br - (double)ar * bi;
  }
  for (int j = 0; j < 64; j++) {
    float r = iq[2 * j], i = iq[2 * j + 1];
    pw += (double)r * r + (double)i * i;
  }
  int above_run = 0;
  int64_t last = -min_spacing;
  int64_t kmax = n - 80;
  for (int64_t k = 0; k < kmax; k++) {
    double m = std::sqrt(cr * cr + ci * ci) / (pw > 1e-12 ? pw : 1e-12);
    if (m > thresh) {
      above_run++;
      if (above_run == run) {
        int64_t start = k - run + 1;
        if (start - last >= min_spacing && found < max_out) {
          out_idx[found++] = (int32_t)start;
          last = start;
        }
      }
    } else {
      above_run = 0;
    }
    // slide: remove j=k term, add j=k+48 term (autocorr), power window 64
    {
      float ar = iq[2 * k], ai = iq[2 * k + 1];
      float br = iq[2 * (k + 16)], bi = iq[2 * (k + 16) + 1];
      cr -= (double)ar * br + (double)ai * bi;
      ci -= (double)ai * br - (double)ar * bi;
      ar = iq[2 * (k + 48)]; ai = iq[2 * (k + 48) + 1];
      br = iq[2 * (k + 64)]; bi = iq[2 * (k + 64) + 1];
      cr += (double)ar * br + (double)ai * bi;
      ci += (double)ai * br - (double)ar * bi;
      float r0 = iq[2 * k], i0 = iq[2 * k + 1];
      float r1 = iq[2 * (k + 64)], i1 = iq[2 * (k + 64) + 1];
      pw += (double)r1 * r1 + (double)i1 * i1 - (double)r0 * r0 - (double)i0 * i0;
    }
  }
  return found;
}

// ---------------------------------------------------------------------------
// SPSC IQ ring buffer with overlap-save block reads
// ---------------------------------------------------------------------------

struct RingBuf {
  std::vector<float> buf;     // interleaved IQ, 2*capacity floats
  int64_t capacity;           // in samples
  std::atomic<int64_t> wr{0}; // total samples written
  std::atomic<int64_t> rd{0}; // total samples consumed (block starts)
};

void* phyrt_rb_create(int64_t capacity) {
  auto* rb = new RingBuf();
  rb->capacity = capacity;
  rb->buf.resize(2 * capacity);
  return rb;
}

void phyrt_rb_destroy(void* h) { delete (RingBuf*)h; }

int64_t phyrt_rb_writable(void* h) {
  auto* rb = (RingBuf*)h;
  return rb->capacity - (rb->wr.load(std::memory_order_acquire) -
                         rb->rd.load(std::memory_order_acquire));
}

// Write n samples (2n floats); returns samples accepted.
int64_t phyrt_rb_write(void* h, const float* iq, int64_t n) {
  auto* rb = (RingBuf*)h;
  int64_t wr = rb->wr.load(std::memory_order_relaxed);
  int64_t space = rb->capacity - (wr - rb->rd.load(std::memory_order_acquire));
  if (n > space) n = space;
  for (int64_t i = 0; i < n; i++) {
    int64_t p = (wr + i) % rb->capacity;
    rb->buf[2 * p] = iq[2 * i];
    rb->buf[2 * p + 1] = iq[2 * i + 1];
  }
  rb->wr.store(wr + n, std::memory_order_release);
  return n;
}

// Read a block of n samples plus `halo` lookahead (overlap-save): the read
// pointer advances by n but n+halo samples are copied out.  Returns 1 on
// success, 0 if not enough data buffered yet.
int phyrt_rb_read_block(void* h, float* out, int64_t n, int64_t halo) {
  auto* rb = (RingBuf*)h;
  int64_t rd = rb->rd.load(std::memory_order_relaxed);
  int64_t avail = rb->wr.load(std::memory_order_acquire) - rd;
  if (avail < n + halo) return 0;
  for (int64_t i = 0; i < n + halo; i++) {
    int64_t p = (rd + i) % rb->capacity;
    out[2 * i] = rb->buf[2 * p];
    out[2 * i + 1] = rb->buf[2 * p + 1];
  }
  rb->rd.store(rd + n, std::memory_order_release);
  return 1;
}

int64_t phyrt_rb_fill(void* h) {
  auto* rb = (RingBuf*)h;
  return rb->wr.load(std::memory_order_acquire) -
         rb->rd.load(std::memory_order_acquire);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// UDP IQ ingest: a native thread receiving interleaved-cf32 datagrams
// straight into a ring buffer (the GR udp/UHD source equivalent) — Python
// never touches the per-datagram hot path.
// ---------------------------------------------------------------------------

#include <thread>
#include <sys/socket.h>
#include <netinet/in.h>
#include <arpa/inet.h>
#include <unistd.h>

struct UdpIngest {
  int fd = -1;
  int port = 0;
  std::thread th;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> datagrams{0};
  std::atomic<int64_t> samples{0};
  std::atomic<int64_t> dropped{0};  // samples rejected (ring full)
};

extern "C" {

// Start an ingest thread feeding ring `rb_handle` from UDP `port`
// (port 0 = ephemeral).  Returns a handle, or nullptr on socket error.
void* phyrt_udp_ingest_start(void* rb_handle, int port) {
  auto* rb = (RingBuf*)rb_handle;
  auto* u = new UdpIngest();
  u->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (u->fd < 0) { delete u; return nullptr; }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (bind(u->fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(u->fd); delete u; return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(u->fd, (sockaddr*)&addr, &alen);
  u->port = ntohs(addr.sin_port);
  timeval tv{0, 100000};  // 100 ms poll so stop() is responsive
  setsockopt(u->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  // Default rmem (~208 KB) holds only ~6 of the 32 KB sample datagrams a
  // TX burst + block flush emits back-to-back; if this thread is preempted
  // the kernel drops datagrams and the packet's IQ is corrupted mid-air
  // (observed as intermittent small-packet loss in the latency harness).
  // SO_RCVBUFFORCE bypasses rmem_max when running as root; fall back to
  // the capped SO_RCVBUF otherwise.
  int rcvbuf = 16 << 20;
  if (setsockopt(u->fd, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf,
                 sizeof(rcvbuf)) < 0)
    setsockopt(u->fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  u->th = std::thread([u, rb]() {
    std::vector<float> pkt(2 * 8192);
    while (!u->stop.load(std::memory_order_relaxed)) {
      ssize_t r = recv(u->fd, pkt.data(), pkt.size() * sizeof(float), 0);
      if (r <= 0) continue;
      int64_t n = r / (2 * (int64_t)sizeof(float));
      if (n <= 0) continue;
      int64_t acc = phyrt_rb_write(rb, pkt.data(), n);
      u->datagrams.fetch_add(1, std::memory_order_relaxed);
      u->samples.fetch_add(acc, std::memory_order_relaxed);
      if (acc < n) u->dropped.fetch_add(n - acc, std::memory_order_relaxed);
    }
  });
  return u;
}

int phyrt_udp_ingest_port(void* h) { return ((UdpIngest*)h)->port; }

void phyrt_udp_ingest_stats(void* h, int64_t* datagrams, int64_t* samples,
                            int64_t* dropped) {
  auto* u = (UdpIngest*)h;
  *datagrams = u->datagrams.load();
  *samples = u->samples.load();
  *dropped = u->dropped.load();
}

void phyrt_udp_ingest_stop(void* h) {
  auto* u = (UdpIngest*)h;
  u->stop.store(true);
  if (u->th.joinable()) u->th.join();
  close(u->fd);
  delete u;
}

}  // extern "C"
