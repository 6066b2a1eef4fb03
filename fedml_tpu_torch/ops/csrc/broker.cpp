// Native pub/sub broker: the federation's control plane in C++.
//
// Speaks exactly the frame protocol of the Python PubSubBroker
// (fedml_tpu_torch/core/distributed/communication/broker.py), which the
// JAX package's broker speaks too:
//
//   frame   := u32_be len || payload
//   payload := op (1 byte: 'S' subscribe | 'P' publish)
//              || u16_be topic_len || topic || body
//
// with MQTT QoS0 semantics: a publish fans out to every connection
// subscribed to the topic. Single-threaded epoll event loop; per-
// connection buffered reads and non-blocking buffered writes (a slow
// subscriber backlogs its own queue, never the loop). A frame that breaks
// the protocol closes only its own connection.
//
// Usage: broker [port [host]]   (port 0 = ephemeral; prints "LISTENING <port>")
//
// Built at first use by fedml_tpu_torch/ops/_build.py (build_executable)
// with the host C++ compiler into build/fedml_tpu_torch/; run by
// NativePubSubBroker and `python -m fedml_tpu_torch.cli deploy broker --native`.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint32_t kMaxFrame = 1u << 30;
constexpr size_t kMaxWriteBacklog = 1u << 31;  // drop conn beyond 2 GB queued

struct Conn {
  int fd = -1;
  std::string rbuf;                       // unparsed inbound bytes
  std::string wbuf;                       // unflushed outbound bytes
  size_t woff = 0;                        // flushed prefix of wbuf
  std::unordered_set<std::string> topics; // for cleanup on close
};

std::unordered_map<int, Conn> conns;                       // fd -> conn
std::unordered_map<std::string, std::unordered_set<int>> subs; // topic -> fds
// Connections that hit a fatal error are doomed, not closed inline:
// closing frees the Conn, and callers (drain_frames parsing c.rbuf, the
// event loop holding a Conn&) may still be using it. The loop reaps the
// doomed set at a safe point after each epoll batch.
std::unordered_set<int> doomed;
int epfd = -1;

void doom(int fd) { doomed.insert(fd); }

void set_nonblock(int fd) { fcntl(fd, F_SETFL, fcntl(fd, F_GETFL) | O_NONBLOCK); }

void watch(int fd, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(epfd, EPOLL_CTL_MOD, fd, &ev);
}

void close_conn(int fd) {
  auto it = conns.find(fd);
  if (it == conns.end()) return;
  for (const auto& t : it->second.topics) {
    auto s = subs.find(t);
    if (s != subs.end()) {
      s->second.erase(fd);
      if (s->second.empty()) subs.erase(s);
    }
  }
  epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  conns.erase(it);
}

// Queue bytes on a connection; flush greedily, arm EPOLLOUT on backlog.
void send_bytes(Conn& c, const char* data, size_t n) {
  if (doomed.count(c.fd)) return;
  if (c.wbuf.size() - c.woff == 0) {
    // fast path: try a direct write first
    ssize_t w = ::send(c.fd, data, n, MSG_NOSIGNAL);
    if (w == (ssize_t)n) return;
    if (w < 0) {
      if (errno != EAGAIN && errno != EWOULDBLOCK) { doom(c.fd); return; }
      w = 0;
    }
    data += w;
    n -= (size_t)w;
  }
  // backlog = bytes actually pending, not the already-flushed prefix
  if (c.wbuf.size() - c.woff + n > kMaxWriteBacklog) { doom(c.fd); return; }
  c.wbuf.append(data, n);
  watch(c.fd, true);
}

void flush(Conn& c) {
  if (doomed.count(c.fd)) return;
  while (c.woff < c.wbuf.size()) {
    ssize_t w = ::send(c.fd, c.wbuf.data() + c.woff, c.wbuf.size() - c.woff,
                       MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      doom(c.fd);
      return;
    }
    c.woff += (size_t)w;
  }
  if (c.woff == c.wbuf.size()) {
    c.wbuf.clear();
    c.woff = 0;
    watch(c.fd, false);
    return;
  }
  // partial drain: compact once the dead prefix dominates, so a slow
  // subscriber doesn't pin flushed bytes in memory indefinitely
  if (c.woff >= (64u << 10) && c.woff > c.wbuf.size() / 2) {
    c.wbuf.erase(0, c.woff);
    c.woff = 0;
  }
}

void route(const std::string& topic, const char* frame, size_t frame_len) {
  auto s = subs.find(topic);
  if (s == subs.end()) return;
  // copy: send_bytes may close (and erase) subscribers mid-iteration
  std::vector<int> targets(s->second.begin(), s->second.end());
  for (int fd : targets) {
    auto it = conns.find(fd);
    if (it != conns.end()) send_bytes(it->second, frame, frame_len);
  }
}

// Parse complete frames out of c.rbuf. Returns false on protocol error.
bool drain_frames(Conn& c) {
  size_t off = 0;
  while (true) {
    if (c.rbuf.size() - off < 4) break;
    uint32_t len;
    memcpy(&len, c.rbuf.data() + off, 4);
    len = ntohl(len);
    if (len > kMaxFrame || len < 3) return false;
    if (c.rbuf.size() - off < 4 + (size_t)len) break;
    const char* p = c.rbuf.data() + off + 4;
    char op = p[0];
    uint16_t tlen;
    memcpy(&tlen, p + 1, 2);
    tlen = ntohs(tlen);
    if ((size_t)3 + tlen > len) return false;
    std::string topic(p + 3, tlen);
    if (op == 'S') {
      subs[topic].insert(c.fd);
      c.topics.insert(topic);
    } else if (op == 'P') {
      // forward the whole original frame (header included) verbatim
      route(topic, c.rbuf.data() + off, 4 + (size_t)len);
    } else {
      return false;
    }
    off += 4 + (size_t)len;
  }
  c.rbuf.erase(0, off);
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  signal(SIGPIPE, SIG_IGN);
  int port = argc > 1 ? atoi(argv[1]) : 0;
  const char* host = argc > 2 ? argv[2] : "127.0.0.1";

  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    fprintf(stderr, "bad host %s\n", host);
    return 1;
  }
  addr.sin_port = htons((uint16_t)port);
  if (bind(lfd, (sockaddr*)&addr, sizeof addr) != 0 || listen(lfd, 128) != 0) {
    perror("bind/listen");
    return 1;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, (sockaddr*)&addr, &alen);
  printf("LISTENING %d\n", ntohs(addr.sin_port));
  fflush(stdout);
  set_nonblock(lfd);

  epfd = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = lfd;
  epoll_ctl(epfd, EPOLL_CTL_ADD, lfd, &ev);

  std::vector<epoll_event> events(256);
  char buf[1 << 16];
  while (true) {
    int n = epoll_wait(epfd, events.data(), (int)events.size(), -1);
    if (n < 0) {
      if (errno == EINTR) continue;
      perror("epoll_wait");
      return 1;
    }
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      if (fd == lfd) {
        while (true) {
          int cfd = accept(lfd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblock(cfd);
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          epoll_ctl(epfd, EPOLL_CTL_ADD, cfd, &cev);
          conns[cfd].fd = cfd;
        }
        continue;
      }
      auto it = conns.find(fd);
      if (it == conns.end() || doomed.count(fd)) continue;
      Conn& c = it->second;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) {
        doom(fd);
        continue;
      }
      if (events[i].events & EPOLLOUT) flush(c);
      if (events[i].events & EPOLLIN) {
        if (doomed.count(fd)) continue;  // flush may have doomed it
        bool dead = false;
        while (true) {
          ssize_t r = recv(fd, buf, sizeof buf, 0);
          if (r > 0) {
            c.rbuf.append(buf, (size_t)r);
            continue;
          }
          if (r == 0) { dead = true; }
          else if (errno != EAGAIN && errno != EWOULDBLOCK) { dead = true; }
          break;
        }
        // drain_frames may route to (and doom) any conn, including this
        // one — it never frees, so parsing c.rbuf stays safe
        if (!drain_frames(c)) dead = true;  // protocol violation
        if (dead) doom(fd);
      }
    }
    // safe point: no Conn& is live across this batch boundary
    for (int fd : doomed) close_conn(fd);
    doomed.clear();
  }
}
