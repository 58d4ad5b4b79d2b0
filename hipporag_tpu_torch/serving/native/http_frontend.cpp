// Native HTTP/1.1 front-end for the serving tier.
//
// Why native: Python socket handling and thread-per-connection HTTP
// parsing cost the stdlib front end throughput on a small serving host.
// This file moves accept/read/parse/write onto a single epoll event loop
// that runs entirely outside the GIL; Python worker threads pull fully
// parsed requests through a ctypes C API (hf_next) and push JSON responses
// back (hf_respond). The reference framework has no serving surface at all
// (its main.py is a one-shot batch script).
//
// Design:
//   - one event-loop thread: nonblocking listen/accept, per-connection
//     input buffering, minimal HTTP/1.1 parsing (Content-Length bodies,
//     keep-alive), buffered writes with EPOLLOUT backpressure
//   - completed requests go to a mutex+condvar ready queue; hf_next
//     blocks there (ctypes releases the GIL, so N Python workers wait
//     for free)
//   - one outstanding request per connection: responses are written in
//     request order by construction, no pipelining reorder hazard
//   - hf_respond is thread-safe: it enqueues the wire bytes and wakes
//     the loop via eventfd; the loop owns all fds
//   - protocol errors (bad request line, oversized body, chunked
//     encoding) are answered 400/413/501 directly from the loop and the
//     connection is closed
//
// Build: `make` in this directory (see Makefile); loaded via ctypes by
// hipporag_tpu_torch/serving/native_http.py.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kMaxHeaderBytes = 16 * 1024;
constexpr int kMaxEvents = 128;

struct Request {
  uint64_t id;
  uint64_t conn_serial;
  std::string method;
  std::string path;
  std::string body;
  bool responded = false;
};

struct Conn {
  int fd = -1;
  uint64_t serial = 0;
  std::string in;
  std::string out;
  bool busy = false;              // a parsed request is awaiting its response
  bool keep_alive = true;
  bool close_after_write = false; // protocol error or Connection: close
  bool want_write = false;        // EPOLLOUT armed
  // Bytes the current half-parsed request is entitled to buffer (headers +
  // declared body on a large-cap path). 0 = no such request: the read loop
  // then caps c.in at the SMALL body limit, so a client can't pin
  // max_body_ bytes per connection by streaming while busy or headerless.
  size_t expected_total = 0;
  bool head_request = false;  // in-flight request used the HEAD method
};

struct PendingResponse {
  uint64_t conn_serial;
  int status;
  int ctype = 0;  // 0 = application/json, 1 = text/plain (/metrics)
  std::string body;
};

const char* reason_for(int status) {
  switch (status) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 413: return "Payload Too Large";
    case 500: return "Internal Server Error";
    case 501: return "Not Implemented";
    case 503: return "Service Unavailable";
    case 504: return "Gateway Timeout";
    default: return "Status";
  }
}

// head_only: RFC 9110 §9.3.2 — a response to HEAD carries the same
// headers a GET would (including Content-Length of the body it is NOT
// sending) but MUST NOT include a body; writing one desyncs keep-alive
// clients (they parse the stale body bytes as the next status line).
std::string build_response(int status, const char* body, size_t body_len,
                           bool keep_alive, int ctype = 0,
                           bool head_only = false) {
  std::string r;
  r.reserve((head_only ? 0 : body_len) + 192);
  char head[224];
  // ctype 1 is the Prometheus exposition content type (/metrics);
  // everything else on this server speaks JSON.
  const char* ct = ctype == 1
                       ? "text/plain; version=0.0.4; charset=utf-8"
                       : "application/json";
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: %s\r\n"
                   "Content-Length: %zu\r\n"
                   "Connection: %s\r\n\r\n",
                   status, reason_for(status), ct, body_len,
                   keep_alive ? "keep-alive" : "close");
  r.append(head, (size_t)n);
  if (body_len && !head_only) r.append(body, body_len);
  return r;
}

bool iequals(const std::string& a, const char* b) {
  size_t n = strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; ++i) {
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i])) return false;
  }
  return true;
}

std::string lower(std::string s) {
  for (auto& c : s) c = (char)tolower((unsigned char)c);
  return s;
}

class Frontend {
 public:
  Frontend() = default;
  ~Frontend() { destroy(); }

  // Returns 0 on success, -1 on error (last_error_ set).
  int start(const char* host, int port, int backlog, long max_body,
            long max_small_body, const char* large_paths) {
    max_body_ = max_body > 0 ? (size_t)max_body : (size_t)(64u << 20);
    max_small_body_ = max_small_body > 0 ? (size_t)max_small_body : max_body_;
    if (large_paths) {
      std::string lp(large_paths);
      size_t pos = 0;
      while (pos <= lp.size()) {
        size_t comma = lp.find(',', pos);
        if (comma == std::string::npos) comma = lp.size();
        if (comma > pos) large_paths_.push_back(lp.substr(pos, comma - pos));
        pos = comma + 1;
      }
    }
    listen_fd_ = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (listen_fd_ < 0) return fail("socket");
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1)
      return fail("inet_pton: bad host");
    if (bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) < 0) return fail("bind");
    if (listen(listen_fd_, backlog > 0 ? backlog : 128) < 0) return fail("listen");
    socklen_t alen = sizeof(addr);
    if (getsockname(listen_fd_, (sockaddr*)&addr, &alen) < 0)
      return fail("getsockname");
    bound_port_ = ntohs(addr.sin_port);

    event_fd_ = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    if (event_fd_ < 0) return fail("eventfd");
    epoll_fd_ = epoll_create1(EPOLL_CLOEXEC);
    if (epoll_fd_ < 0) return fail("epoll_create1");
    if (add_fd(listen_fd_, 0 /* serial 0 = listen */, EPOLLIN) < 0)
      return fail("epoll_ctl listen");
    if (add_fd(event_fd_, 1 /* serial 1 = eventfd */, EPOLLIN) < 0)
      return fail("epoll_ctl eventfd");
    loop_ = std::thread([this] { run(); });
    return 0;
  }

  int bound_port() const { return bound_port_; }
  const char* last_error() const { return last_error_.c_str(); }

  // 1 = request out, 0 = timeout, -1 = stopped and drained.
  int next(int timeout_ms, uint64_t* id, const char** method, const char** path,
           const char** body, long* body_len) {
    std::unique_lock<std::mutex> lk(queue_mu_);
    if (!queue_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), [this] {
          return !ready_.empty() || stopping_.load();
        }))
      return 0;
    if (ready_.empty()) return stopping_.load() ? -1 : 0;
    std::unique_ptr<Request> req = std::move(ready_.front());
    ready_.pop_front();
    Request* raw = req.get();
    inflight_[raw->id] = std::move(req);
    *id = raw->id;
    *method = raw->method.c_str();
    *path = raw->path.c_str();
    *body = raw->body.data();
    *body_len = (long)raw->body.size();
    return 1;
  }

  int respond(uint64_t id, int status, const char* body, long body_len,
              int ctype = 0) {
    uint64_t conn_serial;
    {
      std::lock_guard<std::mutex> lk(queue_mu_);
      auto it = inflight_.find(id);
      if (it == inflight_.end() || it->second->responded) return -1;
      it->second->responded = true;
      conn_serial = it->second->conn_serial;
    }
    // keep-alive is a per-connection decision owned by the loop, so the
    // wire bytes are built there; workers only ship status + body + ctype.
    PendingResponse pr;
    pr.conn_serial = conn_serial;
    pr.status = status;
    pr.ctype = ctype;
    pr.body.assign(body ? body : "", body_len > 0 ? (size_t)body_len : 0);
    {
      std::lock_guard<std::mutex> lk(resp_mu_);
      responses_.push_back(std::move(pr));
    }
    // Erase only AFTER the response is queued: the stop-drain check scans
    // inflight_ then responses_, so the request must stay visible in one
    // of them at every instant or a stop() in the gap drops the response.
    {
      std::lock_guard<std::mutex> lk(queue_mu_);
      inflight_.erase(id);
    }
    wake();
    return 0;
  }

  void stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) {
      queue_cv_.notify_all();
      return;
    }
    queue_cv_.notify_all();
    wake();
  }

  void destroy() {
    stop();
    exit_.store(true);
    wake();
    if (loop_.joinable()) loop_.join();
    if (listen_fd_ >= 0) { close(listen_fd_); listen_fd_ = -1; }
    if (event_fd_ >= 0) { close(event_fd_); event_fd_ = -1; }
    if (epoll_fd_ >= 0) { close(epoll_fd_); epoll_fd_ = -1; }
    for (auto& kv : conns_) {
      if (kv.second.fd >= 0) close(kv.second.fd);  // loop joined: safe here
    }
    conns_.clear();
  }

  // counters for stats/tests
  uint64_t accepted() const { return accepted_.load(); }
  uint64_t parsed() const { return parsed_.load(); }
  uint64_t responded() const { return responded_.load(); }
  uint64_t protocol_errors() const { return protocol_errors_.load(); }

 private:
  int fail(const char* what) {
    last_error_ = std::string(what) + ": " + strerror(errno);
    return -1;
  }

  int add_fd(int fd, uint64_t serial, uint32_t events) {
    epoll_event ev{};
    ev.events = events;
    ev.data.u64 = serial;
    return epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev);
  }

  void mod_conn(Conn& c, bool want_write) {
    if (c.want_write == want_write) return;
    c.want_write = want_write;
    epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? (uint32_t)EPOLLOUT : 0u);
    ev.data.u64 = c.serial;
    epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, c.fd, &ev);
  }

  void wake() {
    if (event_fd_ >= 0) {
      uint64_t one = 1;
      ssize_t n = write(event_fd_, &one, sizeof(one));
      (void)n;
    }
  }

  void close_conn(uint64_t serial) {
    auto it = conns_.find(serial);
    if (it == conns_.end()) return;
    epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, it->second.fd, nullptr);
    close(it->second.fd);
    conns_.erase(it);
  }

  void run() {
    std::vector<epoll_event> events(kMaxEvents);
    bool listen_closed = false;
    while (!exit_.load()) {
      if (stopping_.load() && !listen_closed && listen_fd_ >= 0) {
        epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, listen_fd_, nullptr);
        close(listen_fd_);
        listen_fd_ = -1;
        listen_closed = true;
        // idle connections have nothing owed to them — close now
        std::vector<uint64_t> idle;
        for (auto& kv : conns_)
          if (!kv.second.busy && kv.second.out.empty()) idle.push_back(kv.first);
        for (uint64_t s : idle) close_conn(s);
      }
      int n = epoll_wait(epoll_fd_, events.data(), kMaxEvents, 200);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      for (int i = 0; i < n; ++i) {
        uint64_t serial = events[i].data.u64;
        uint32_t ev = events[i].events;
        if (serial == 0) {
          accept_loop();
        } else if (serial == 1) {
          uint64_t buf;
          while (read(event_fd_, &buf, sizeof(buf)) > 0) {
          }
          flush_responses();
        } else {
          auto it = conns_.find(serial);
          if (it == conns_.end()) continue;
          Conn& c = it->second;
          bool dead = false;
          if (ev & (EPOLLHUP | EPOLLERR)) dead = true;
          if (!dead && (ev & EPOLLIN)) dead = !on_readable(c);
          if (!dead && (ev & EPOLLOUT)) dead = !on_writable(c);
          if (dead) close_conn(serial);
        }
      }
      // stopping + nothing in flight or owed -> exit loop
      if (stopping_.load()) {
        std::lock_guard<std::mutex> lk(queue_mu_);
        bool owed = !ready_.empty() || !inflight_.empty();
        if (!owed) {
          std::lock_guard<std::mutex> lk2(resp_mu_);
          if (responses_.empty()) {
            bool writing = false;
            for (auto& kv : conns_)
              if (!kv.second.out.empty()) { writing = true; break; }
            if (!writing) break;
          }
        }
      }
    }
    queue_cv_.notify_all();
  }

  void accept_loop() {
    while (true) {
      int fd = accept4(listen_fd_, nullptr, nullptr,
                       SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) break;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      uint64_t serial = next_serial_++;
      Conn& c = conns_[serial];
      c.fd = fd;
      c.serial = serial;
      if (add_fd(fd, serial, EPOLLIN) < 0) {
        close(fd);
        conns_.erase(serial);
        continue;
      }
      accepted_.fetch_add(1);
    }
  }

  // false -> close connection
  bool on_readable(Conn& c) {
    char buf[64 * 1024];
    while (true) {
      ssize_t n = read(c.fd, buf, sizeof(buf));
      if (n > 0) {
        if (c.close_after_write) continue;  // discard post-error bytes
        c.in.append(buf, (size_t)n);
        // Before headers complete (or while a response is owed), a client
        // is only entitled to small-body + header bytes; a half-received
        // large-path request raises the cap to exactly its declared total.
        size_t cap = std::max(c.expected_total,
                              max_small_body_ + kMaxHeaderBytes) +
                     kMaxHeaderBytes;
        if (c.in.size() > cap) {
          // A fast client can deliver headers + a multi-MiB large-path
          // body without the loop ever hitting EAGAIN — entitlement
          // (c.expected_total) is normally established by parse_requests
          // AFTER the drain. Parse now so a legitimate /index upload is
          // never mistaken for a flood; while a response is owed (busy)
          // the small cap stands — that is the attack window. Parsing also
          // when expected_total != 0 lets a completed large body be
          // consumed mid-burst, so keep-alive bytes PIPELINED behind it
          // are judged against the busy small-cap instead of 413ing the
          // whole connection.
          if (!c.busy) {
            if (!parse_requests(c)) return false;
            if (c.close_after_write) return true;  // error response owed
            cap = std::max(c.expected_total,
                           max_small_body_ + kMaxHeaderBytes) +
                  kMaxHeaderBytes;
          }
          if (c.in.size() > cap) {
            return protocol_error(c, 413, "{\"error\": \"body too large\"}");
          }
        }
        continue;
      }
      if (n == 0) return false;  // peer closed
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      return false;
    }
    if (c.close_after_write) return true;  // response already owed/flushing
    return parse_requests(c);
  }

  // Answer a malformed request directly from the loop and mark the
  // connection for closing. Returns pump_write's verdict: false once the
  // error response is fully flushed (or the socket died) -> close now.
  bool protocol_error(Conn& c, int status, const char* json) {
    protocol_errors_.fetch_add(1);
    c.out += build_response(status, json, strlen(json), false);
    c.close_after_write = true;
    c.in.clear();
    return pump_write(c);
  }

  // false -> close connection now
  bool parse_requests(Conn& c) {
    while (!c.busy && !c.close_after_write && !stopping_.load()) {
      size_t hdr_end = c.in.find("\r\n\r\n");
      if (hdr_end == std::string::npos) {
        if (c.in.size() > kMaxHeaderBytes) {
          return protocol_error(c, 400, "{\"error\": \"headers too large\"}");
        }
        return true;
      }
      // request line
      size_t line_end = c.in.find("\r\n");
      std::string line = c.in.substr(0, line_end);
      size_t sp1 = line.find(' ');
      size_t sp2 = line.rfind(' ');
      if (sp1 == std::string::npos || sp2 == sp1) {
        return protocol_error(c, 400, "{\"error\": \"malformed request line\"}");
      }
      std::string method = line.substr(0, sp1);
      std::string path = line.substr(sp1 + 1, sp2 - sp1 - 1);
      std::string version = line.substr(sp2 + 1);
      bool http11 = version == "HTTP/1.1";
      // headers
      long content_length = 0;
      bool keep_alive = http11;
      bool chunked = false;
      size_t pos = line_end + 2;
      while (pos < hdr_end) {
        size_t eol = c.in.find("\r\n", pos);
        if (eol == std::string::npos || eol > hdr_end) eol = hdr_end;
        size_t colon = c.in.find(':', pos);
        if (colon != std::string::npos && colon < eol) {
          std::string key = lower(c.in.substr(pos, colon - pos));
          size_t vs = colon + 1;
          while (vs < eol && c.in[vs] == ' ') ++vs;
          std::string val = c.in.substr(vs, eol - vs);
          if (key == "content-length") {
            errno = 0;
            char* end = nullptr;
            content_length = strtol(val.c_str(), &end, 10);
            if (errno || (end && *end) || content_length < 0) {
              return protocol_error(c, 400, "{\"error\": \"invalid Content-Length\"}");
            }
          } else if (key == "connection") {
            std::string v = lower(val);
            if (v == "close") keep_alive = false;
            else if (v == "keep-alive") keep_alive = true;
          } else if (key == "transfer-encoding") {
            chunked = true;
          } else if (key == "expect" && iequals(val, "100-continue")) {
            // Send the interim response ONCE per request: while a declared
            // body is still streaming in, every read event re-scans these
            // buffered headers (expected_total != 0 marks that re-scan), and
            // a strict client accepts at most one 1xx before the final
            // response.
            if (c.expected_total == 0) {
              c.out += "HTTP/1.1 100 Continue\r\n\r\n";
              if (!pump_write(c)) return false;  // peer died mid-handshake
            }
          }
        }
        pos = eol + 2;
      }
      if (chunked) {
        return protocol_error(c, 501, "{\"error\": \"chunked encoding not supported\"}");
      }
      size_t path_cap = max_body_;
      if (!large_paths_.empty()) {
        bool large = false;
        for (const auto& lp : large_paths_) {
          if (path == lp) { large = true; break; }
        }
        if (!large) path_cap = max_small_body_;
      }
      if ((size_t)content_length > path_cap) {
        // enforced BEFORE buffering: a /retrieve must not make the loop
        // hold a 64 MiB body that dispatch would reject anyway
        return protocol_error(c, 413, "{\"error\": \"body too large\"}");
      }
      size_t total = hdr_end + 4 + (size_t)content_length;
      if (c.in.size() < total) {
        c.in.reserve(total);
        c.expected_total = total;  // entitle the read loop to buffer it
        return true;  // need more bytes
      }
      c.expected_total = 0;
      auto req = std::make_unique<Request>();
      req->id = next_request_id_.fetch_add(1);
      req->conn_serial = c.serial;
      req->method = std::move(method);
      req->path = std::move(path);
      req->body = c.in.substr(hdr_end + 4, (size_t)content_length);
      c.in.erase(0, total);
      c.keep_alive = keep_alive;
      c.head_request = req->method == "HEAD";
      c.busy = true;
      parsed_.fetch_add(1);
      {
        std::lock_guard<std::mutex> lk(queue_mu_);
        ready_.push_back(std::move(req));
      }
      queue_cv_.notify_one();
    }
    return true;
  }

  void flush_responses() {
    std::deque<PendingResponse> batch;
    {
      std::lock_guard<std::mutex> lk(resp_mu_);
      batch.swap(responses_);
    }
    while (!batch.empty()) {
      PendingResponse pr = std::move(batch.front());
      batch.pop_front();
      auto it = conns_.find(pr.conn_serial);
      responded_.fetch_add(1);
      if (it == conns_.end()) continue;  // client went away
      Conn& c = it->second;
      bool ka = c.keep_alive && !stopping_.load();
      c.out += build_response(pr.status, pr.body.data(), pr.body.size(), ka,
                              pr.ctype, /*head_only=*/c.head_request);
      if (!ka) c.close_after_write = true;
      c.head_request = false;
      c.busy = false;
      if (!pump_write(c)) {
        close_conn(pr.conn_serial);
        continue;
      }
      // pipelined bytes may already be buffered
      if (!c.close_after_write && !parse_requests(c)) close_conn(pr.conn_serial);
    }
  }

  // false -> connection is dead
  bool pump_write(Conn& c) {
    while (!c.out.empty()) {
      ssize_t n = write(c.fd, c.out.data(), c.out.size());
      if (n > 0) {
        c.out.erase(0, (size_t)n);
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        mod_conn(c, true);
        return true;
      }
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    mod_conn(c, false);
    if (c.close_after_write) return false;
    return true;
  }

  bool on_writable(Conn& c) { return pump_write(c); }

  size_t max_body_ = 64u << 20;        // cap for large_paths_ (e.g. /index)
  size_t max_small_body_ = 64u << 20;  // cap for every other path
  std::vector<std::string> large_paths_;
  int listen_fd_ = -1;
  int event_fd_ = -1;
  int epoll_fd_ = -1;
  int bound_port_ = 0;
  std::thread loop_;
  std::atomic<bool> stopping_{false};
  std::atomic<bool> exit_{false};
  std::string last_error_;

  // loop-owned
  std::unordered_map<uint64_t, Conn> conns_;
  uint64_t next_serial_ = 2;  // 0 = listen, 1 = eventfd

  // shared
  std::mutex queue_mu_;
  std::condition_variable queue_cv_;
  std::deque<std::unique_ptr<Request>> ready_;
  std::unordered_map<uint64_t, std::unique_ptr<Request>> inflight_;
  std::atomic<uint64_t> next_request_id_{1};

  std::mutex resp_mu_;
  std::deque<PendingResponse> responses_;

  std::atomic<uint64_t> accepted_{0};
  std::atomic<uint64_t> parsed_{0};
  std::atomic<uint64_t> responded_{0};
  std::atomic<uint64_t> protocol_errors_{0};
};

}  // namespace

extern "C" {

void* hf_start(const char* host, int port, int backlog, long max_body,
               long max_small_body, const char* large_paths,
               int* out_port, char* err, int err_len) {
  auto* fe = new Frontend();
  if (fe->start(host, port, backlog, max_body, max_small_body,
                large_paths) != 0) {
    if (err && err_len > 0) {
      snprintf(err, (size_t)err_len, "%s", fe->last_error());
    }
    delete fe;
    return nullptr;
  }
  if (out_port) *out_port = fe->bound_port();
  return fe;
}

int hf_next(void* h, int timeout_ms, uint64_t* id, const char** method,
            const char** path, const char** body, long* body_len) {
  return static_cast<Frontend*>(h)->next(timeout_ms, id, method, path, body,
                                         body_len);
}

int hf_respond(void* h, uint64_t id, int status, const char* body,
               long body_len) {
  return static_cast<Frontend*>(h)->respond(id, status, body, body_len);
}

// v2: adds a content-type selector (0 = application/json, 1 = text/plain
// Prometheus exposition). Kept as a separate export so a stale .so under
// the old ABI keeps working (the binding probes for hf_respond2 and falls
// back to hf_respond, which mislabels /metrics as JSON but stays correct).
int hf_respond2(void* h, uint64_t id, int status, int ctype,
                const char* body, long body_len) {
  return static_cast<Frontend*>(h)->respond(id, status, body, body_len,
                                            ctype);
}

void hf_stop(void* h) { static_cast<Frontend*>(h)->stop(); }

void hf_destroy(void* h) {
  auto* fe = static_cast<Frontend*>(h);
  fe->destroy();
  delete fe;
}

void hf_counters(void* h, uint64_t* accepted, uint64_t* parsed,
                 uint64_t* responded, uint64_t* protocol_errors) {
  auto* fe = static_cast<Frontend*>(h);
  if (accepted) *accepted = fe->accepted();
  if (parsed) *parsed = fe->parsed();
  if (responded) *responded = fe->responded();
  if (protocol_errors) *protocol_errors = fe->protocol_errors();
}

}  // extern "C"
