// Native HTTP/SSE transport of krasis_tpu_torch's server: the same C++
// epoll server as krasis_tpu/native/serve.cpp, kept as the port's own copy
// (the port imports nothing of krasis_tpu).
//
// Design: one epoll event-loop thread owns all sockets — accept, read,
// HTTP parse, disconnect detection (EPOLLRDHUP), and draining buffered
// writes. Python worker threads pull parsed requests via ks_next() (a
// condvar wait — ctypes releases the GIL) and push responses through
// ks_respond / ks_stream_send. Writes from worker threads are try-send
// + buffer: the generation loop NEVER blocks on a slow client socket —
// the epoll thread drains the buffer via EPOLLOUT. With the stdlib Python
// server, every streamed token write (wfile.flush) can stall the engine
// callback behind the GIL and a blocking socket; here token emission is
// O(memcpy).
//
// Deliberately minimal HTTP/1.1: request-line + headers + Content-Length
// bodies, keep-alive for one-shot responses, chunked transfer for SSE
// (same framing the Python server uses), Connection: close after a
// stream. No TLS: plain HTTP on localhost.
//
// Build (krasis_tpu_torch/native/__init__.py does it at first use):
//   g++ -O2 -shared -fPIC -pthread serve.cpp -o libkrasis_serve.so

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

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kMaxHeaderBytes = 64 * 1024;
constexpr size_t kMaxBodyBytes = 64ul * 1024 * 1024;
constexpr size_t kMaxOutbufBytes = 256ul * 1024 * 1024;

struct Conn {
  int fd = -1;
  std::string inbuf;
  std::string outbuf;   // pending bytes the socket wouldn't take yet
  bool out_armed = false;        // EPOLLOUT currently requested
  bool closed = false;           // client gone or fd closed
  bool close_after_flush = false;
  std::atomic<bool> in_flight{false};  // a parsed request is being handled
  std::atomic<bool> reparse{false};    // leftover inbuf may hold next request
  std::atomic<bool> peer_eof{false};   // client half-closed (SHUT_WR / close)
  std::atomic<bool> streaming{false};  // SSE response in progress
  // parser state for the current request
  bool have_headers = false;
  size_t body_start = 0;
  long content_length = 0;
  std::string method, path;
  std::mutex mu;  // guards outbuf/out_armed/closed/close_after_flush
};

using ConnPtr = std::shared_ptr<Conn>;

struct Request {
  long id;
  ConnPtr conn;
  std::string method, path, body;
};

struct Server {
  int listen_fd = -1;
  int epfd = -1;
  int wake_fd = -1;  // eventfd: stop + reparse kicks
  int port = 0;
  std::thread loop;
  std::atomic<bool> stopping{false};

  std::mutex conns_mu;
  std::unordered_map<int, ConnPtr> conns;  // fd -> conn (epoll thread owns)

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<std::shared_ptr<Request>> queue;

  std::mutex req_mu;
  std::unordered_map<long, std::shared_ptr<Request>> reqs;  // in-flight
  std::atomic<long> next_req{1};
};

std::mutex g_servers_mu;
std::unordered_map<int, std::unique_ptr<Server>> g_servers;
int g_next_handle = 1;

Server* get_server(int h) {
  std::lock_guard<std::mutex> lk(g_servers_mu);
  auto it = g_servers.find(h);
  return it == g_servers.end() ? nullptr : it->second.get();
}

// Recompute the epoll interest set for a connection. Called from any
// thread; epoll_ctl is thread-safe and c->mu serializes the decision.
void update_events_locked(Server* s, Conn* c) {
  if (c->closed || c->fd < 0) return;
  epoll_event ev{};
  ev.events = EPOLLIN | EPOLLRDHUP | (c->out_armed ? (uint32_t)EPOLLOUT : 0u);
  ev.data.fd = c->fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// Append bytes to a connection, writing through immediately when the
// socket will take them. Returns 0 on success, -1 if the client is gone.
int conn_send(Server* s, const ConnPtr& c, const char* data, size_t n) {
  std::lock_guard<std::mutex> lk(c->mu);
  if (c->closed) return -1;
  if (c->outbuf.empty()) {
    while (n > 0) {
      ssize_t w = ::send(c->fd, data, n, MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w > 0) {
        data += w;
        n -= (size_t)w;
      } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else {
        c->closed = true;  // EPIPE / ECONNRESET — epoll thread reaps the fd
        return -1;
      }
    }
  }
  if (n > 0) {
    if (c->outbuf.size() + n > kMaxOutbufBytes) {
      c->closed = true;  // pathological client; drop it
      return -1;
    }
    c->outbuf.append(data, n);
    if (!c->out_armed) {
      c->out_armed = true;
      update_events_locked(s, c.get());
    }
  }
  return 0;
}

void wake(Server* s) {
  uint64_t one = 1;
  ssize_t r = write(s->wake_fd, &one, sizeof one);
  (void)r;
}

// epoll thread: close and forget a connection.
void reap_conn(Server* s, const ConnPtr& c) {
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    fd = c->fd;
    if (fd >= 0) {
      epoll_ctl(s->epfd, EPOLL_CTL_DEL, fd, nullptr);
      ::close(fd);
      c->fd = -1;
    }
    c->closed = true;
  }
  if (fd >= 0) {
    std::lock_guard<std::mutex> lk(s->conns_mu);
    auto it = s->conns.find(fd);
    if (it != s->conns.end() && it->second == c) s->conns.erase(it);
  }
}

// Try to parse one complete request out of c->inbuf (epoll thread only).
// Returns true if a request was queued.
bool try_parse(Server* s, const ConnPtr& c) {
  if (c->in_flight.load()) return false;  // one request at a time per conn
  if (!c->have_headers) {
    size_t he = c->inbuf.find("\r\n\r\n");
    if (he == std::string::npos) {
      if (c->inbuf.size() > kMaxHeaderBytes) reap_conn(s, c);
      return false;
    }
    // request line: METHOD SP PATH SP VERSION
    size_t eol = c->inbuf.find("\r\n");
    std::string line = c->inbuf.substr(0, eol);
    size_t sp1 = line.find(' ');
    size_t sp2 = line.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1) {
      reap_conn(s, c);
      return false;
    }
    c->method = line.substr(0, sp1);
    c->path = line.substr(sp1 + 1, sp2 - sp1 - 1);
    c->content_length = 0;
    // headers: only Content-Length matters to us
    size_t pos = eol + 2;
    while (pos < he) {
      size_t end = c->inbuf.find("\r\n", pos);
      std::string h = c->inbuf.substr(pos, end - pos);
      size_t colon = h.find(':');
      if (colon != std::string::npos) {
        std::string name = h.substr(0, colon);
        for (auto& ch : name) ch = (char)tolower((unsigned char)ch);
        if (name == "content-length") {
          c->content_length = atol(h.c_str() + colon + 1);
          if (c->content_length < 0 ||
              (size_t)c->content_length > kMaxBodyBytes) {
            reap_conn(s, c);
            return false;
          }
        }
      }
      pos = end + 2;
    }
    c->have_headers = true;
    c->body_start = he + 4;
  }
  if (c->inbuf.size() < c->body_start + (size_t)c->content_length)
    return false;

  auto req = std::make_shared<Request>();
  req->conn = c;
  req->method = std::move(c->method);
  req->path = std::move(c->path);
  req->body = c->inbuf.substr(c->body_start, (size_t)c->content_length);
  c->inbuf.erase(0, c->body_start + (size_t)c->content_length);
  c->have_headers = false;
  c->in_flight.store(true);

  req->id = s->next_req.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(s->req_mu);
    s->reqs[req->id] = req;
  }
  {
    std::lock_guard<std::mutex> lk(s->q_mu);
    s->queue.push_back(req);
  }
  s->q_cv.notify_one();
  return true;
}

void event_loop(Server* s) {
  epoll_event evs[64];
  while (!s->stopping.load()) {
    int n = epoll_wait(s->epfd, evs, 64, 500);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // reparse kicks: connections whose one-shot response finished and
    // whose inbuf may already hold a pipelined next request
    std::vector<ConnPtr> to_reparse, to_reap;
    {
      std::lock_guard<std::mutex> lk(s->conns_mu);
      for (auto& [fd, c] : s->conns) {
        if (c->reparse.exchange(false)) to_reparse.push_back(c);
        std::lock_guard<std::mutex> clk(c->mu);
        if (c->closed && c->outbuf.empty()) to_reap.push_back(c);
      }
    }
    for (auto& c : to_reap) reap_conn(s, c);
    for (auto& c : to_reparse)
      if (!c->closed) try_parse(s, c);

    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      uint32_t e = evs[i].events;
      if (fd == s->wake_fd) {
        uint64_t junk;
        ssize_t r = read(s->wake_fd, &junk, sizeof junk);
        (void)r;
        continue;
      }
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          auto c = std::make_shared<Conn>();
          c->fd = cfd;
          {
            std::lock_guard<std::mutex> lk(s->conns_mu);
            s->conns[cfd] = c;
          }
          epoll_event ev{};
          ev.events = EPOLLIN | EPOLLRDHUP;
          ev.data.fd = cfd;
          epoll_ctl(s->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      ConnPtr c;
      {
        std::lock_guard<std::mutex> lk(s->conns_mu);
        auto it = s->conns.find(fd);
        if (it == s->conns.end()) continue;
        c = it->second;
      }
      if (e & (EPOLLHUP | EPOLLERR)) {
        // hard error: both directions are gone; in-flight handlers
        // observe closed=true via ks_cancelled / failed sends
        reap_conn(s, c);
        continue;
      }
      if (e & (EPOLLIN | EPOLLRDHUP)) {
        // Drain BEFORE honoring a hangup: EPOLLIN|EPOLLRDHUP arrive
        // together when a client writes a full request then half-closes
        // (shutdown(SHUT_WR)) — that request must still be parsed and
        // served; only the response path learns whether the peer truly
        // disappeared (write error) or just finished sending.
        char buf[16384];
        bool oversized = false;
        for (;;) {
          ssize_t r = ::recv(fd, buf, sizeof buf, MSG_DONTWAIT);
          if (r > 0) {
            c->inbuf.append(buf, (size_t)r);
            if (c->inbuf.size() > kMaxHeaderBytes + kMaxBodyBytes) {
              oversized = true;
              break;
            }
          } else if (r == 0) {
            c->peer_eof.store(true);
            break;
          } else {
            if (errno != EAGAIN && errno != EWOULDBLOCK)
              c->peer_eof.store(true);
            break;
          }
        }
        if (e & EPOLLRDHUP) c->peer_eof.store(true);
        if (oversized) {
          reap_conn(s, c);
          continue;
        }
        bool queued = try_parse(s, c);
        if (c->peer_eof.load()) {
          if (c->streaming.load()) {
            // client aborted an in-progress SSE stream → cancel decode
            std::lock_guard<std::mutex> lk(c->mu);
            c->closed = true;
          } else if (!c->in_flight.load() && !queued) {
            reap_conn(s, c);  // idle connection closed normally
            continue;
          }
          // else: a pending one-shot request from a half-closed client —
          // leave it; ks_respond closes after the response flushes
        }
      }
      if (e & EPOLLOUT) {
        std::lock_guard<std::mutex> lk(c->mu);
        while (!c->outbuf.empty()) {
          ssize_t w = ::send(fd, c->outbuf.data(), c->outbuf.size(),
                             MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w > 0) {
            c->outbuf.erase(0, (size_t)w);
          } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            break;
          } else {
            c->closed = true;
            break;
          }
        }
        if (c->outbuf.empty() && c->out_armed) {
          c->out_armed = false;
          update_events_locked(s, c.get());
          if (c->close_after_flush) c->closed = true;
        }
      }
      // a write path (worker thread or the flush above) may have marked
      // the connection closed — reap it here, on the epoll thread
      {
        bool dead;
        {
          std::lock_guard<std::mutex> lk(c->mu);
          dead = c->closed;
        }
        if (dead) reap_conn(s, c);
      }
    }
  }
  // teardown: close everything
  std::lock_guard<std::mutex> lk(s->conns_mu);
  for (auto& [fd, c] : s->conns) {
    std::lock_guard<std::mutex> clk(c->mu);
    c->closed = true;
    ::close(fd);
    c->fd = -1;
  }
  s->conns.clear();
}

std::shared_ptr<Request> take_req(Server* s, long id) {
  std::lock_guard<std::mutex> lk(s->req_mu);
  auto it = s->reqs.find(id);
  return it == s->reqs.end() ? nullptr : it->second;
}

void finish_req(Server* s, long id) {
  std::shared_ptr<Request> req;
  {
    std::lock_guard<std::mutex> lk(s->req_mu);
    auto it = s->reqs.find(id);
    if (it == s->reqs.end()) return;
    req = it->second;
    s->reqs.erase(it);
  }
  req->conn->in_flight.store(false);
  req->conn->reparse.store(true);  // epoll thread re-checks leftover inbuf
  wake(s);
}

const char* reason(int status) {
  switch (status) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 413: return "Payload Too Large";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    default: return "Unknown";
  }
}

}  // namespace

extern "C" {

// Returns a server handle (>0) or -errno.
int ks_start(const char* host, int port) {
  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (lfd < 0) return -errno;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(lfd);
    return -EINVAL;
  }
  if (bind(lfd, (sockaddr*)&addr, sizeof addr) < 0 || listen(lfd, 256) < 0) {
    int e = errno;
    ::close(lfd);
    return -e;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, (sockaddr*)&addr, &alen);

  auto s = std::make_unique<Server>();
  s->listen_fd = lfd;
  s->port = ntohs(addr.sin_port);
  s->epfd = epoll_create1(0);
  s->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = lfd;
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, lfd, &ev);
  ev.data.fd = s->wake_fd;
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wake_fd, &ev);
  Server* sp = s.get();
  s->loop = std::thread([sp] { event_loop(sp); });

  std::lock_guard<std::mutex> lk(g_servers_mu);
  int h = g_next_handle++;
  g_servers[h] = std::move(s);
  return h;
}

int ks_port(int h) {
  Server* s = get_server(h);
  return s ? s->port : -1;
}

void ks_stop(int h) {
  std::unique_ptr<Server> s;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    auto it = g_servers.find(h);
    if (it == g_servers.end()) return;
    s = std::move(it->second);
    g_servers.erase(it);
  }
  s->stopping.store(true);
  wake(s.get());
  s->q_cv.notify_all();
  s->loop.join();
  ::close(s->listen_fd);
  ::close(s->epfd);
  ::close(s->wake_fd);
}

// Blocks up to timeout_ms for the next parsed request. Returns the
// request id (>0), 0 on timeout, -1 if the server is stopping.
long ks_next(int h, int timeout_ms, char* method, int mcap, char* path,
             int pcap, long* body_len) {
  Server* s = get_server(h);
  if (!s) return -1;
  std::shared_ptr<Request> req;
  {
    std::unique_lock<std::mutex> lk(s->q_mu);
    if (!s->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return s->stopping.load() || !s->queue.empty();
        }))
      return 0;
    if (s->stopping.load() && s->queue.empty()) return -1;
    req = s->queue.front();
    s->queue.pop_front();
  }
  snprintf(method, (size_t)mcap, "%s", req->method.c_str());
  snprintf(path, (size_t)pcap, "%s", req->path.c_str());
  *body_len = (long)req->body.size();
  return req->id;
}

int ks_copy_body(int h, long req_id, char* buf, long cap) {
  Server* s = get_server(h);
  if (!s) return -1;
  auto req = take_req(s, req_id);
  if (!req) return -1;
  long n = (long)req->body.size();
  if (n > cap) return -1;
  memcpy(buf, req->body.data(), (size_t)n);
  return 0;
}

// 1 if the client disconnected (handler should abort generation).
int ks_cancelled(int h, long req_id) {
  Server* s = get_server(h);
  if (!s) return 1;
  auto req = take_req(s, req_id);
  if (!req) return 1;
  std::lock_guard<std::mutex> lk(req->conn->mu);
  return req->conn->closed ? 1 : 0;
}

int ks_respond(int h, long req_id, int status, const char* ctype,
               const char* body, long n) {
  Server* s = get_server(h);
  if (!s) return -1;
  auto req = take_req(s, req_id);
  if (!req) return -1;
  char hdr[512];
  int hn = snprintf(hdr, sizeof hdr,
                    "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                    "Content-Length: %ld\r\nConnection: keep-alive\r\n\r\n",
                    status, reason(status), ctype, n);
  std::string out;
  out.reserve((size_t)(hn + n));
  out.append(hdr, (size_t)hn);
  out.append(body, (size_t)n);
  int rc = conn_send(s, req->conn, out.data(), out.size());
  if (req->conn->peer_eof.load()) {
    // half-closed client: no further requests can arrive — close once
    // the response has flushed
    std::lock_guard<std::mutex> lk(req->conn->mu);
    if (req->conn->outbuf.empty())
      req->conn->closed = true;
    else
      req->conn->close_after_flush = true;
  }
  finish_req(s, req_id);
  return rc;
}

int ks_stream_start(int h, long req_id) {
  Server* s = get_server(h);
  if (!s) return -1;
  auto req = take_req(s, req_id);
  if (!req) return -1;
  req->conn->streaming.store(true);
  const char hdr[] =
      "HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
      "Cache-Control: no-cache\r\nTransfer-Encoding: chunked\r\n"
      "Connection: close\r\n\r\n";
  return conn_send(s, req->conn, hdr, sizeof hdr - 1);
}

int ks_stream_send(int h, long req_id, const char* data, long n) {
  Server* s = get_server(h);
  if (!s) return -1;
  auto req = take_req(s, req_id);
  if (!req) return -1;
  char pre[32];
  int pn = snprintf(pre, sizeof pre, "%lx\r\n", n);
  std::string out;
  out.reserve((size_t)(pn + n + 2));
  out.append(pre, (size_t)pn);
  out.append(data, (size_t)n);
  out.append("\r\n");
  return conn_send(s, req->conn, out.data(), out.size());
}

int ks_stream_end(int h, long req_id) {
  Server* s = get_server(h);
  if (!s) return -1;
  auto req = take_req(s, req_id);
  if (!req) return -1;
  int rc = conn_send(s, req->conn, "0\r\n\r\n", 5);
  {
    std::lock_guard<std::mutex> lk(req->conn->mu);
    if (req->conn->outbuf.empty())
      req->conn->closed = true;  // epoll thread reaps on next tick
    else
      req->conn->close_after_flush = true;
  }
  wake(s);
  finish_req(s, req_id);
  return rc;
}

}  // extern "C"
