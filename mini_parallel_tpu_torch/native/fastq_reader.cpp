// Native FASTQ(.gz) decoder + read batcher.
//
// C++ replacement for the reference's host data plane: the Rust streaming
// reader with its spawned `zcat` child (smith_waterman/src/aligner.rs:107-178)
// and the flate2-based `linecount` tool (tools/linecount.rs). Decodes gzip
// in-process with zlib, parses 4-line FASTQ records (sequence = line 2 of
// each record, aligner.rs:138), and batches reads into caller-provided flat
// buffers (concatenated bytes + offsets) ready to be padded into device
// tensors without further Python-side copying.
//
// A background decode thread keeps one chunk of readahead so gzip inflation
// overlaps device compute — the double-buffering the reference attempted and
// reverted ("MIMD approach ... reverted due to complexity",
// improvements.txt:21,42).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kInflateBuf = 1 << 20;

struct Chunk {
  std::vector<uint8_t> bytes;    // concatenated read bytes
  std::vector<int64_t> offsets;  // size n_reads+1; read i = [off[i], off[i+1])
  std::vector<uint8_t> qbytes;   // concatenated qual bytes (want_quals mode)
  std::vector<int64_t> qoffsets;
  bool final_chunk = false;
  std::string error;
};

// Streaming line source over a plain or gzip file.
class LineSource {
 public:
  explicit LineSource(const char* path) {
    gz_ = gzopen(path, "rb");
    if (gz_ == nullptr) {
      error_ = std::string("cannot open ") + path;
    }
  }
  ~LineSource() {
    if (gz_ != nullptr) gzclose(gz_);
  }

  bool ok() const { return error_.empty(); }
  const std::string& error() const { return error_; }
  bool eof() const { return eof_ && pos_ >= buf_len_; }

  // Returns false at EOF or error; line excludes the trailing \n / \r\n.
  // On a stream ERROR any partial line is dropped (returning it would hand
  // the consumer a truncated sequence as if it were complete); only a clean
  // EOF returns a final newline-less line.
  bool next_line(std::string* line) {
    line->clear();
    while (true) {
      if (pos_ >= buf_len_) {
        if (eof_) return ok() && !line->empty();
        if (!fill()) return ok() && !line->empty();
      }
      const char* start = buf_.data() + pos_;
      const char* nl = static_cast<const char*>(
          memchr(start, '\n', buf_len_ - pos_));
      if (nl == nullptr) {
        line->append(start, buf_len_ - pos_);
        pos_ = buf_len_;
        continue;
      }
      size_t n = static_cast<size_t>(nl - start);
      line->append(start, n);
      pos_ += n + 1;
      if (!line->empty() && line->back() == '\r') line->pop_back();
      return true;
    }
  }

 private:
  bool fill() {
    if (buf_.size() < kInflateBuf) buf_.resize(kInflateBuf);
    int n = gzread(gz_, buf_.data(), static_cast<unsigned>(buf_.size()));
    if (n < 0) {
      int errnum = 0;
      const char* msg = gzerror(gz_, &errnum);
      error_ = std::string("gzread failed: ") + (msg ? msg : "?");
      eof_ = true;
      return false;
    }
    if (n == 0) {
      // gzread returns 0 both at clean EOF and on a TRUNCATED stream; only
      // gzerror distinguishes them (Z_BUF_ERROR = unexpected end of input)
      int errnum = 0;
      const char* msg = gzerror(gz_, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) {
        error_ = std::string("gzip stream error: ") +
                 (msg && *msg ? msg : "unexpected end of file");
      }
      eof_ = true;
      return false;
    }
    buf_len_ = static_cast<size_t>(n);
    pos_ = 0;
    return true;
  }

  gzFile gz_ = nullptr;
  std::vector<char> buf_;
  size_t buf_len_ = 0;
  size_t pos_ = 0;
  bool eof_ = false;
  std::string error_;
};

// Is `line` valid UTF-8?  The reference reads lines via Rust's
// BufRead::lines(), which yields Err exactly when a line is not valid
// UTF-8 (aligner.rs:132); the per-line error tolerance below keys off the
// same predicate so "malformed line" means the same thing in both.
bool utf8_valid(const std::string& line) {
  const auto* p = reinterpret_cast<const unsigned char*>(line.data());
  const unsigned char* end = p + line.size();
  while (p < end) {
    unsigned char c = *p;
    if (c < 0x80) {
      ++p;
    } else if ((c & 0xE0) == 0xC0) {
      if (end - p < 2 || (p[1] & 0xC0) != 0x80 || c < 0xC2) return false;
      p += 2;
    } else if ((c & 0xF0) == 0xE0) {
      if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
        return false;
      if (c == 0xE0 && p[1] < 0xA0) return false;  // overlong
      if (c == 0xED && p[1] >= 0xA0) return false;  // surrogate
      p += 3;
    } else if ((c & 0xF8) == 0xF0) {
      if (end - p < 4 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80 ||
          (p[3] & 0xC0) != 0x80)
        return false;
      if (c == 0xF0 && p[1] < 0x90) return false;   // overlong
      if (c == 0xF4 && p[1] >= 0x90) return false;  // > U+10FFFF
      if (c > 0xF4) return false;
      p += 4;
    } else {
      return false;
    }
  }
  return true;
}

constexpr int64_t kMaxLineErrors = 10;  // aligner.rs:161: abort when >10

struct Reader {
  std::unique_ptr<LineSource> src;
  int64_t chunk_size_reads = 0;
  bool want_quals = false;  // also capture line 4 of each record
  // atomics: mutated by the worker thread, read by fq_line_count /
  // fq_total_reads on the consumer thread (values reflect producer
  // readahead — up to kMaxQueue chunks ahead of what was consumed)
  std::atomic<int64_t> line_count{0};
  std::atomic<int64_t> total_reads{0};
  std::atomic<int64_t> error_count{0};

  // readahead
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<std::unique_ptr<Chunk>> queue;
  bool done = false, stop = false;
  std::string error;

  static constexpr size_t kMaxQueue = 2;

  void run() {
    auto chunk = std::make_unique<Chunk>();
    chunk->offsets.push_back(0);
    if (want_quals) chunk->qoffsets.push_back(0);
    std::string line;
    while (true) {
      {
        std::lock_guard<std::mutex> l(mu);
        if (stop) return;
      }
      if (!src->ok()) {
        std::lock_guard<std::mutex> l(mu);
        error = src->error();
        done = true;
        cv_consume.notify_all();
        return;
      }
      if (!src->next_line(&line)) {
        if (!src->error().empty()) {
          std::lock_guard<std::mutex> l(mu);
          error = src->error();
        }
        break;
      }
      // Per-line error tolerance (aligner.rs:155-163): a malformed
      // (non-UTF-8) line is skipped WITHOUT advancing line_count — the
      // reference's Err arm does not bump its counter either, so record
      // framing shifts identically — and >10 such lines abort the file.
      if (!utf8_valid(line)) {
        int64_t errs = ++error_count;
        if (errs > kMaxLineErrors) {
          std::lock_guard<std::mutex> l(mu);
          error = "Too many read errors (>10), stopping at line " +
                  std::to_string(line_count.load());
          break;
        }
        continue;
      }
      ++line_count;
      int64_t m = line_count % 4;
      if (m == 2) {  // sequence line (aligner.rs:138)
        chunk->bytes.insert(chunk->bytes.end(), line.begin(), line.end());
        chunk->offsets.push_back(static_cast<int64_t>(chunk->bytes.size()));
        ++total_reads;
        // without quals, a record is complete at its sequence line
        if (!want_quals &&
            static_cast<int64_t>(chunk->offsets.size()) - 1 >=
                chunk_size_reads) {
          push(std::move(chunk));
          chunk = std::make_unique<Chunk>();
          chunk->offsets.push_back(0);
        }
      } else if (m == 0 && want_quals) {  // quality line completes a record
        chunk->qbytes.insert(chunk->qbytes.end(), line.begin(), line.end());
        chunk->qoffsets.push_back(static_cast<int64_t>(chunk->qbytes.size()));
        if (static_cast<int64_t>(chunk->qoffsets.size()) - 1 >=
            chunk_size_reads) {
          push(std::move(chunk));
          chunk = std::make_unique<Chunk>();
          chunk->offsets.push_back(0);
          chunk->qoffsets.push_back(0);
        }
      }
    }
    if (want_quals) {  // truncated final record: pad missing quals as empty
      while (chunk->qoffsets.size() < chunk->offsets.size()) {
        chunk->qoffsets.push_back(
            static_cast<int64_t>(chunk->qbytes.size()));
      }
    }
    bool had_error;
    {
      std::lock_guard<std::mutex> l(mu);
      had_error = !error.empty();
    }
    // never hand the consumer a chunk cut short by a stream error: the
    // caller must see the -1/error, not a silently truncated batch
    if (!had_error && chunk->offsets.size() > 1) push(std::move(chunk));
    std::lock_guard<std::mutex> l(mu);
    done = true;
    cv_consume.notify_all();
  }

  void push(std::unique_ptr<Chunk> c) {
    std::unique_lock<std::mutex> l(mu);
    cv_produce.wait(l, [&] { return queue.size() < kMaxQueue || stop; });
    if (stop) return;
    queue.push_back(std::move(c));
    cv_consume.notify_one();
  }

  std::unique_ptr<Chunk> pop() {
    std::unique_lock<std::mutex> l(mu);
    cv_consume.wait(l, [&] { return !queue.empty() || done; });
    if (queue.empty()) return nullptr;
    auto c = std::move(queue.front());
    queue.pop_front();
    cv_produce.notify_one();
    return c;
  }
};

}  // namespace

extern "C" {

void* fq_open_q(const char* path, int64_t chunk_size_reads,
                int32_t want_quals) {
  auto* r = new Reader();
  r->src = std::make_unique<LineSource>(path);
  r->want_quals = want_quals != 0;
  r->chunk_size_reads = chunk_size_reads > 0 ? chunk_size_reads : 1;
  if (!r->src->ok()) {
    // keep the handle so fq_error can report; worker marks done immediately
  }
  r->worker = std::thread([r] { r->run(); });
  return r;
}

void* fq_open(const char* path, int64_t chunk_size_reads) {
  return fq_open_q(path, chunk_size_reads, 0);
}

// Copies the next chunk into caller buffers.
// Returns: n_reads (>0), 0 at end-of-file, -1 error (see fq_error),
// -2 caller buffers too small (then *needed_bytes/*needed_reads are set).
int64_t fq_next_chunk(void* handle, uint8_t* bytes, int64_t bytes_cap,
                      int64_t* offsets, int64_t offsets_cap,
                      int64_t* needed_bytes, int64_t* needed_reads) {
  auto* r = static_cast<Reader*>(handle);
  auto c = r->pop();
  if (c == nullptr) {
    std::lock_guard<std::mutex> l(r->mu);
    return r->error.empty() ? 0 : -1;
  }
  int64_t n_reads = static_cast<int64_t>(c->offsets.size()) - 1;
  int64_t n_bytes = static_cast<int64_t>(c->bytes.size());
  if (needed_bytes) *needed_bytes = n_bytes;
  if (needed_reads) *needed_reads = n_reads;
  if (n_bytes > bytes_cap || n_reads + 1 > offsets_cap) {
    // put it back so the caller can retry with bigger buffers
    std::lock_guard<std::mutex> l(r->mu);
    r->queue.push_front(std::move(c));
    return -2;
  }
  memcpy(bytes, c->bytes.data(), static_cast<size_t>(n_bytes));
  memcpy(offsets, c->offsets.data(),
         static_cast<size_t>((n_reads + 1) * sizeof(int64_t)));
  return n_reads;
}

// Quals variant: additionally copies the quality lines. Same return
// contract as fq_next_chunk; -2 also sets *needed_qbytes.
int64_t fq_next_chunk_q(void* handle, uint8_t* bytes, int64_t bytes_cap,
                        int64_t* offsets, int64_t offsets_cap,
                        uint8_t* qbytes, int64_t qbytes_cap,
                        int64_t* qoffsets, int64_t qoffsets_cap,
                        int64_t* needed_bytes, int64_t* needed_reads,
                        int64_t* needed_qbytes) {
  auto* r = static_cast<Reader*>(handle);
  auto c = r->pop();
  if (c == nullptr) {
    std::lock_guard<std::mutex> l(r->mu);
    return r->error.empty() ? 0 : -1;
  }
  int64_t n_reads = static_cast<int64_t>(c->offsets.size()) - 1;
  int64_t n_bytes = static_cast<int64_t>(c->bytes.size());
  int64_t n_qbytes = static_cast<int64_t>(c->qbytes.size());
  if (needed_bytes) *needed_bytes = n_bytes;
  if (needed_reads) *needed_reads = n_reads;
  if (needed_qbytes) *needed_qbytes = n_qbytes;
  if (n_bytes > bytes_cap || n_reads + 1 > offsets_cap ||
      n_qbytes > qbytes_cap || n_reads + 1 > qoffsets_cap) {
    std::lock_guard<std::mutex> l(r->mu);
    r->queue.push_front(std::move(c));
    return -2;
  }
  memcpy(bytes, c->bytes.data(), static_cast<size_t>(n_bytes));
  memcpy(offsets, c->offsets.data(),
         static_cast<size_t>((n_reads + 1) * sizeof(int64_t)));
  memcpy(qbytes, c->qbytes.data(), static_cast<size_t>(n_qbytes));
  memcpy(qoffsets, c->qoffsets.data(),
         static_cast<size_t>((n_reads + 1) * sizeof(int64_t)));
  return n_reads;
}

const char* fq_error(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  std::lock_guard<std::mutex> l(r->mu);
  return r->error.c_str();
}

int64_t fq_total_reads(void* handle) {
  return static_cast<Reader*>(handle)->total_reads;
}

int64_t fq_line_count(void* handle) {
  return static_cast<Reader*>(handle)->line_count;
}

// Malformed (skipped) line count — the reference's error_count
// (aligner.rs:130,156); >10 aborts the stream with fq_error set.
int64_t fq_error_count(void* handle) {
  return static_cast<Reader*>(handle)->error_count;
}

void fq_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  {
    std::lock_guard<std::mutex> l(r->mu);
    r->stop = true;
    r->cv_produce.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

// Standalone line counter — the `linecount` tool (tools/linecount.rs:6-30).
int64_t fq_count_lines(const char* path) {
  LineSource src(path);
  if (!src.ok()) return -1;
  std::string line;
  int64_t n = 0;
  while (src.next_line(&line)) ++n;
  if (!src.error().empty()) return -1;
  return n;
}

}  // extern "C"
