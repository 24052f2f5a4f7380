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
// A multi-member gzip file (BGZF, or members compressed in parallel) has
// its members inflated ahead on worker threads (MemberSource): the framing
// thread sees the bytes a sequential gzread would give it, in the same
// 1 MiB windows, with the same errors. Plain files, pipes and anything
// not starting with gzip magic are read through gzread.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <fcntl.h>
#include <sched.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kInflateBuf = 1 << 20;  // the framer's window, gzread's call
constexpr size_t kReadBuf = 1 << 20;     // compressed bytes per pread
constexpr size_t kPiece = 1 << 20;       // a worker's unit of inflated output
// Inflated bytes held ahead of the framer, per reader, whatever the file's
// size (the member the framer is on may add one piece beyond it).
constexpr size_t kAheadBudget = size_t{256} << 20;
constexpr size_t kMaxJobs = 64;  // members claimed ahead, per reader
constexpr int kMaxWorkers = 8;

struct Chunk {
  std::vector<uint8_t> bytes;    // concatenated read bytes
  std::vector<int64_t> offsets;  // size n_reads+1; read i = [off[i], off[i+1])
  std::vector<uint8_t> qbytes;   // concatenated qual bytes (want_quals mode)
  std::vector<int64_t> qoffsets;
  bool final_chunk = false;
  std::string error;
};

// Worker threads for all readers of the process: the CPUs it may run on,
// less the consumer, prefetch and framing threads, at most kMaxWorkers.
int max_workers() {
  static const int n = [] {
    cpu_set_t set;
    int cpus = sched_getaffinity(0, sizeof set, &set) == 0
                   ? CPU_COUNT(&set)
                   : static_cast<int>(std::thread::hardware_concurrency());
    return cpus < 2 ? 0 : std::clamp(cpus - 3, 1, kMaxWorkers);
  }();
  return n;
}

std::atomic<int>& free_slots() {
  static std::atomic<int> slots{max_workers()};
  return slots;
}

std::atomic<int> open_member_readers{0};

bool acquire_slot() {
  int f = free_slots().load();
  while (f > 0) {
    if (free_slots().compare_exchange_weak(f, f - 1)) return true;
  }
  return false;
}

bool pread_all(int fd, uint8_t* out, size_t n, uint64_t off) {
  while (n > 0) {
    ssize_t r = pread(fd, out, n, static_cast<off_t>(off));
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      if (r == 0) errno = 0;
      return false;
    }
    out += r;
    n -= static_cast<size_t>(r);
    off += static_cast<uint64_t>(r);
  }
  return true;
}

// zlib inflate of one gzip member at a time, its input read with pread,
// its errors in gzread's words.
class Inflater {
 public:
  enum Status { kFull, kEnd, kError, kTruncated };

  Inflater(int fd, uint64_t size) : fd_(fd), size_(size), in_(kReadBuf) {}
  ~Inflater() {
    if (init_) inflateEnd(&zs_);
  }

  // Start the member at `start`. `keep`: the input read so far runs on
  // from `start` (it follows the member this inflater just ended).
  void begin(uint64_t start, bool keep) {
    if (!init_) {
      init_ = inflateInit2(&zs_, 16 + MAX_WBITS) == Z_OK;
      keep = false;
    } else {
      inflateReset(&zs_);
    }
    start_ = start;
    if (!keep) {
      zs_.next_in = in_.data();
      zs_.avail_in = 0;
      read_to_ = start;
    }
  }

  // The file offset after the bytes consumed (the member's end at kEnd).
  uint64_t pos() const { return start_ + zs_.total_in; }

  // Inflate into out[0, cap) until it is full (kFull), the member ends
  // (kEnd), its data is bad (kError) or the file ends first (kTruncated).
  Status inflate_into(uint8_t* out, size_t cap, size_t* n, std::string* msg) {
    *n = 0;
    if (!init_) {
      *msg = "out of memory";
      return kError;
    }
    zs_.next_out = out;
    zs_.avail_out = static_cast<uInt>(cap);
    Status st = kFull;
    while (zs_.avail_out > 0) {
      if (zs_.avail_in == 0) {
        if (read_to_ >= size_) {
          *msg = "unexpected end of file";
          st = kTruncated;
          break;
        }
        size_t want = static_cast<size_t>(
            std::min<uint64_t>(in_.size(), size_ - read_to_));
        if (!pread_all(fd_, in_.data(), want, read_to_)) {
          int e = errno;  // 0: the file is shorter than it was
          *msg = e ? std::strerror(e) : "unexpected end of file";
          st = e ? kError : kTruncated;
          break;
        }
        zs_.next_in = in_.data();
        zs_.avail_in = static_cast<uInt>(want);
        read_to_ += want;
      }
      int ret = inflate(&zs_, Z_NO_FLUSH);
      if (ret == Z_STREAM_END) {
        st = kEnd;
        break;
      }
      if (ret == Z_DATA_ERROR) {
        *msg = zs_.msg ? zs_.msg : "compressed data error";
        st = kError;
        break;
      }
      if (ret == Z_MEM_ERROR) {
        *msg = "out of memory";
        st = kError;
        break;
      }
      if (ret == Z_NEED_DICT || ret == Z_STREAM_ERROR) {
        *msg = "internal error: inflate stream corrupt";
        st = kError;
        break;
      }
    }
    *n = cap - zs_.avail_out;
    return st;
  }

 private:
  int fd_;
  uint64_t size_;
  std::vector<uint8_t> in_;
  z_stream zs_{};
  bool init_ = false;
  uint64_t start_ = 0;
  uint64_t read_to_ = 0;  // file offset up to which input was read
};

// A candidate member inflated ahead by a worker, its output in pieces.
struct Job {
  explicit Job(uint64_t s) : start(s) {}
  uint64_t start;
  std::deque<std::vector<uint8_t>> pieces;  // not yet taken by the framer
  size_t held = 0;                          // bytes in `pieces`
  bool done = false, cancel = false;
  bool handed = false;  // the framer's own member, taken over
  Inflater::Status status = Inflater::kFull;
  uint64_t end = 0;  // the member's end, at kEnd
  std::string msg;
};

// The inflated stream of a multi-member gzip file, handed to the framing
// thread in file order. The framer inflates the member it is on itself
// unless a worker holds it; workers scan ahead for member starts (a BGZF
// header's BC subfield gives the next exactly; else a candidate header,
// 1f 8b 08 with the reserved flag bits clear) and inflate them
// speculatively. A worker's member is used only where the member before
// it, inflated in order, ended; any other candidate is dropped. So the
// framer sees what a sequential gzread sees, byte for byte.
class MemberSource {
 public:
  enum Outcome { kBytes, kEof, kDataError, kTruncated };

  MemberSource(int fd, uint64_t size)
      : fd_(fd), size_(size), self_(std::make_unique<Inflater>(fd, size)) {
    ++open_member_readers;
    self_->begin(0, false);
    hint_ = bgzf_next(0);
  }

  ~MemberSource() {
    {
      std::lock_guard<std::mutex> l(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_framer_.notify_all();
    for (auto& t : threads_) t.join();
    --open_member_readers;
    ::close(fd_);
  }

  // The next window of the stream: up to `cap` bytes, fewer only at its
  // end. As gzread: a window in which the data goes bad is dropped
  // (kDataError); a file that ends inside a member yields what inflated
  // and then kTruncated; bytes after the last member that are not a gzip
  // header are ignored.
  Outcome read(uint8_t* out, size_t cap, size_t* n, std::string* msg) {
    *n = 0;
    if (truncated_) {
      *msg = "unexpected end of file";
      return kTruncated;
    }
    spawn_workers();
    hand_off();
    size_t len = 0;
    while (len < cap && mode_ != kDone) {
      Inflater::Status st;
      uint64_t end = 0;
      if (mode_ == kSelf) {
        size_t got = 0;
        st = self_->inflate_into(out + len, cap - len, &got, msg);
        len += got;
        if (st == Inflater::kFull) continue;
        end = self_->pos();
      } else {
        if (piece_pos_ < piece_.size()) {
          size_t k = std::min(cap - len, piece_.size() - piece_pos_);
          std::memcpy(out + len, piece_.data() + piece_pos_, k);
          len += k;
          piece_pos_ += k;
          continue;
        }
        std::unique_lock<std::mutex> l(mu_);
        cv_framer_.wait(l,
                        [&] { return !job_->pieces.empty() || job_->done; });
        if (!job_->pieces.empty()) {
          piece_ = std::move(job_->pieces.front());
          job_->pieces.pop_front();
          job_->held -= piece_.size();
          held_ -= piece_.size();
          piece_pos_ = 0;
          l.unlock();
          cv_work_.notify_all();
          continue;
        }
        st = job_->status;
        end = job_->end;
        *msg = job_->msg;
      }
      if (st == Inflater::kEnd) {
        if (mode_ == kJob && !job_->handed) ++ahead_;
        next_member(end);
        continue;
      }
      if (st == Inflater::kError) return kDataError;
      if (len == 0) return kTruncated;
      truncated_ = true;
      break;
    }
    *n = len;
    return len > 0 ? kBytes : kEof;
  }

  void stats(int64_t* out) const {
    out[0] = members_;
    out[1] = ahead_;
    out[2] = rejected_;
  }

 private:
  enum Mode { kSelf, kJob, kDone };

  bool gzip_magic_at(uint64_t off) {
    uint8_t b[2];
    return size_ - std::min(size_, off) >= 2 && pread_all(fd_, b, 2, off) &&
           b[0] == 0x1f && b[1] == 0x8b;
  }

  // A candidate member start: gzip magic, deflate, reserved flags clear.
  static bool candidate(const uint8_t* p) {
    return p[0] == 0x1f && p[1] == 0x8b && p[2] == 8 && (p[3] & 0xE0) == 0;
  }

  // Where the next member starts by the BC subfield (BSIZE) of the header
  // at `off`; 0 when the header has none.
  uint64_t bgzf_next(uint64_t off) {
    uint8_t h[12];
    if (off + 12 > size_ || !pread_all(fd_, h, 12, off) || !(h[3] & 4))
      return 0;
    size_t xlen = h[10] | (h[11] << 8);
    std::vector<uint8_t> x(xlen);
    if (off + 12 + xlen > size_ || !pread_all(fd_, x.data(), xlen, off + 12))
      return 0;
    for (size_t i = 0; i + 4 <= xlen;) {
      size_t slen = x[i + 2] | (x[i + 3] << 8);
      if (x[i] == 'B' && x[i + 1] == 'C' && slen == 2 && i + 6 <= xlen)
        return off + (x[i + 4] | (x[i + 5] << 8)) + 1;
      i += 4 + slen;
    }
    return 0;
  }

  // The first candidate at or after `from` (scan_mu_ held); 0 at the end.
  uint64_t scan(uint64_t from) {
    if (scan_buf_.empty()) scan_buf_.resize(kReadBuf);
    while (from + 4 <= size_ && !stop_) {
      size_t n = static_cast<size_t>(
          std::min<uint64_t>(scan_buf_.size(), size_ - from));
      if (!pread_all(fd_, scan_buf_.data(), n, from)) return 0;
      const uint8_t* p = scan_buf_.data();
      const uint8_t* last = p + n - 3;
      while (p < last) {
        p = static_cast<const uint8_t*>(std::memchr(p, 0x1f, last - p));
        if (p == nullptr) break;
        if (candidate(p)) return from + (p - scan_buf_.data());
        ++p;
      }
      from += n - 3;
    }
    return 0;
  }

  // The member that the framer was on ended at `end`: go on to the next
  // member, taking a worker's if one started there.
  void next_member(uint64_t end) {
    ++members_;
    bool more = gzip_magic_at(end);  // else EOF, or trailing bytes ignored
    bool keep = mode_ == kSelf;
    {
      std::lock_guard<std::mutex> l(mu_);
      for (auto it = jobs_.begin();
           it != jobs_.end() && (!more || it->first < end);) {
        drop(*it->second);
        it = jobs_.erase(it);
      }
      floor_ = more ? end : size_;
      job_.reset();
      auto it = jobs_.find(end);
      if (!more) {
        mode_ = kDone;
      } else if (it != jobs_.end()) {
        job_ = it->second;
        jobs_.erase(it);
        mode_ = kJob;
        piece_.clear();
        piece_pos_ = 0;
      } else {
        mode_ = kSelf;
      }
    }
    cv_work_.notify_all();
    if (mode_ == kSelf) {
      if (!self_) self_ = std::make_unique<Inflater>(fd_, size_);
      self_->begin(end, keep);
    }
  }

  // A candidate that proved false (mu_ held).
  void drop(Job& job) {
    job.cancel = true;
    held_ -= job.held;
    job.held = 0;
    job.pieces.clear();
    ++rejected_;
  }

  int fair_share() const {
    return std::max(1,
                    max_workers() / std::max(1, open_member_readers.load()));
  }

  // Join the workers that have ended, and start more (spawn_locked).
  void spawn_workers() {
    std::vector<std::thread> ended;
    {
      std::lock_guard<std::mutex> l(mu_);
      for (auto id : ended_ids_) {
        auto it = std::find_if(
            threads_.begin(), threads_.end(),
            [&](const std::thread& t) { return t.get_id() == id; });
        ended.push_back(std::move(*it));
        threads_.erase(it);
      }
      ended_ids_.clear();
      spawn_locked();
    }
    for (auto& t : ended) t.join();
  }

  // Start workers up to this reader's share of the slots: one, to scan,
  // until a candidate is found (mu_ held).
  void spawn_locked() {
    int target = stop_ || scan_done_ || floor_ >= size_ ? 0
                 : found_                              ? fair_share()
                                                       : 1;
    while (live_ < target && acquire_slot()) {
      ++live_;
      threads_.emplace_back([this] { work(); });
    }
  }

  // Once the file shows a second member, a worker takes over the member
  // the framer is inflating, so that its framing overlaps its inflate.
  void hand_off() {
    if (mode_ != kSelf) return;
    std::lock_guard<std::mutex> l(mu_);
    if (!found_ || stop_ || !acquire_slot()) return;
    job_ = std::make_shared<Job>(floor_);
    job_->handed = true;
    mode_ = kJob;
    piece_.clear();
    piece_pos_ = 0;
    ++live_;
    threads_.emplace_back(
        [this, inf = std::shared_ptr<Inflater>(std::move(self_)), job = job_] {
          work(inf, job);
        });
  }

  void work(std::shared_ptr<Inflater> inf = nullptr,
            std::shared_ptr<Job> handed = nullptr) {
    if (handed) {
      run(*inf, *handed, true);
    } else {
      inf = std::make_shared<Inflater>(fd_, size_);
    }
    while (auto job = claim()) run(*inf, *job, false);
    std::lock_guard<std::mutex> l(mu_);
    ended_ids_.push_back(std::this_thread::get_id());
    free_slots().fetch_add(1);
  }

  // The next candidate ahead of the framer, as a job of this worker; null
  // when the worker should end (it is then no longer counted live).
  std::shared_ptr<Job> claim() {
    std::lock_guard<std::mutex> s(scan_mu_);
    while (true) {
      uint64_t from, floor;
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_work_.wait(l, [&] { return stop_ || jobs_.size() < kMaxJobs; });
        if (stop_ || scan_done_ || live_ > fair_share()) {
          --live_;
          return nullptr;
        }
        floor = floor_;
        from = std::max(scan_pos_, floor + 1);
      }
      if (hint_ < from && from == floor + 1) hint_ = bgzf_next(floor);
      uint8_t h[4];
      uint64_t c = hint_ >= from && hint_ + 4 <= size_ &&
                           pread_all(fd_, h, 4, hint_) && candidate(h)
                       ? hint_
                       : scan(from);
      hint_ = c ? bgzf_next(c) : 0;
      std::lock_guard<std::mutex> l(mu_);
      if (c == 0 || stop_) {
        scan_done_ = true;
        --live_;
        return nullptr;
      }
      scan_pos_ = c + 1;
      if (c <= floor_) continue;  // the framer passed it meanwhile
      auto job = std::make_shared<Job>(c);
      jobs_.emplace(c, job);
      if (!found_) {
        found_ = true;
        spawn_locked();
      }
      return job;
    }
  }

  // Inflate a job piece by piece within the budget; the member the framer
  // waits on may always add one piece.
  void run(Inflater& inf, Job& job, bool resume) {
    if (!resume) inf.begin(job.start, false);
    while (true) {
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_work_.wait(l, [&] {
          return stop_ || job.cancel || held_ + kPiece <= kAheadBudget ||
                 (job_.get() == &job && job.pieces.empty());
        });
        if (stop_ || job.cancel) return;
        held_ += kPiece;
      }
      std::vector<uint8_t> piece(kPiece);
      size_t n = 0;
      std::string msg;
      Inflater::Status st = inf.inflate_into(piece.data(), kPiece, &n, &msg);
      piece.resize(n);
      if (n < kPiece / 2) piece.shrink_to_fit();
      {
        std::lock_guard<std::mutex> l(mu_);
        held_ -= kPiece;
        if (job.cancel || stop_) return;
        if (n > 0) {
          job.held += n;
          held_ += n;
          job.pieces.push_back(std::move(piece));
        }
        if (st != Inflater::kFull) {
          job.done = true;
          job.status = st;
          job.end = inf.pos();
          job.msg = msg;
        }
      }
      cv_framer_.notify_all();
      if (st != Inflater::kFull) return;
    }
  }

  const int fd_;
  const uint64_t size_;

  // the framer's side
  std::unique_ptr<Inflater> self_;  // null while a worker holds it
  Mode mode_ = kSelf;
  std::shared_ptr<Job> job_;  // the worker's member the framer is on
  std::vector<uint8_t> piece_;
  size_t piece_pos_ = 0;
  bool truncated_ = false;
  std::atomic<int64_t> members_{0}, ahead_{0}, rejected_{0};

  // shared, under mu_
  std::mutex mu_;
  std::condition_variable cv_work_, cv_framer_;
  std::map<uint64_t, std::shared_ptr<Job>> jobs_;
  size_t held_ = 0;
  uint64_t floor_ = 0;  // start of the member the framer is on
  std::atomic<bool> stop_{false};
  bool found_ = false, scan_done_ = false;
  int live_ = 0;
  std::vector<std::thread> threads_;
  std::vector<std::thread::id> ended_ids_;

  // the scan, under scan_mu_ (scan_pos_ also under mu_)
  std::mutex scan_mu_;
  uint64_t scan_pos_ = 1, hint_ = 0;
  std::vector<uint8_t> scan_buf_;
};

// Streaming line source over a plain or gzip file.
class LineSource {
 public:
  explicit LineSource(const char* path) : path_(path) {
    int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd >= 0) {
      struct stat st;
      uint8_t magic[2];
      if (fstat(fd, &st) == 0 && S_ISREG(st.st_mode) &&
          pread_all(fd, magic, 2, 0) && magic[0] == 0x1f &&
          magic[1] == 0x8b) {
        members_ = std::make_unique<MemberSource>(
            fd, static_cast<uint64_t>(st.st_size));
        return;
      }
      ::close(fd);
    }
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

  // members, members inflated ahead by a worker, candidates dropped
  void member_stats(int64_t* out) const {
    if (members_) {
      members_->stats(out);
    } else {
      out[0] = out[1] = out[2] = 0;
    }
  }

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
    if (members_) return fill_members();
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

  // fill() from the member source, with gzread's error texts
  bool fill_members() {
    size_t n = 0;
    std::string msg;
    auto got = members_->read(reinterpret_cast<uint8_t*>(buf_.data()),
                              buf_.size(), &n, &msg);
    if (got == MemberSource::kBytes) {
      buf_len_ = n;
      pos_ = 0;
      return true;
    }
    if (got == MemberSource::kDataError) {
      error_ = "gzread failed: " + path_ + ": " + msg;
    } else if (got == MemberSource::kTruncated) {
      error_ = "gzip stream error: " + path_ + ": " + msg;
    }
    eof_ = true;
    return false;
  }

  std::string path_;
  std::unique_ptr<MemberSource> members_;  // a gzip regular file
  gzFile gz_ = nullptr;  // anything else
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

// A gzip file's member counters: out[0] members inflated, out[1] those a
// worker inflated ahead of the framer, out[2] candidate starts that proved
// false. All 0 for a file read through gzread.
void fq_member_stats(void* handle, int64_t* out) {
  static_cast<Reader*>(handle)->src->member_stats(out);
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
