// Copy of the JAX package's src/object_store/store.cc (built from here into
// ray_tpu_torch/_private/object_store/_build/ at first use).
//
// ray_tpu shared-memory object store daemon ("plasma-equivalent").
//
// Reference behavior modeled on src/ray/object_manager/plasma/
// (store.h, object_lifecycle_manager.h:106, eviction_policy.h:159,
// dlmalloc allocator, fling.cc fd passing, create_request_queue.h
// backpressure) — re-designed, not ported: one pre-sized shm pool is
// mapped by every client once (fd passed via SCM_RIGHTS at connect), a
// best-fit free-list allocator with coalescing hands out offsets, and a
// single-threaded epoll loop serves a compact binary protocol.
//
// Protocol (little-endian):
//   frame  := u32 payload_len, u8 msg_type, payload
//   CONNECT  (1): {} -> reply {u64 pool_size} + SCM_RIGHTS fd
//   CREATE   (2): {id[28], u64 data_size} -> {i32 status, u64 offset}
//   SEAL     (3): {id[28]} -> {i32 status}
//   GET      (4): {u32 n, n*id[28], i64 timeout_ms}
//                 -> {u32 n, n*{i32 status, u64 offset, u64 size}}
//                 (blocks server-side until sealed or timeout)
//   RELEASE  (5): {id[28]} -> {i32 status}
//   CONTAINS (6): {id[28]} -> {i32 status}   (0 sealed, 1 created, 2 absent)
//   DELETE   (7): {id[28]} -> {i32 status}
//   METRICS  (8): {} -> {u64 capacity, u64 allocated, u64 num_objects,
//                        u64 num_evictions, u64 bytes_evicted}
//   ABORT    (9): {id[28]} -> {i32 status}   (abort unsealed create)
//   LIST    (10): {} -> {u32 n, n*{id[28], u64 size, u8 sealed, u8 pinned}}
//                 (LRU order, oldest first — spill candidates first;
//                  serves the raylet's spill-on-pressure policy)
//
// status codes: 0 OK, -1 FULL, -2 EXISTS, -3 NOT_FOUND, -4 NOT_SEALED,
//               -5 TIMEOUT, -6 IN_USE.
//
// argv: store <socket> <capacity> [no-evict]. With no-evict the store
// returns FULL instead of silently dropping LRU objects — the raylet then
// spills to disk (reference: local_object_manager.h:145) so no data is
// ever lost; without it the original LRU eviction applies (replica
// caches).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kIdSize = 28;
constexpr uint8_t MSG_CONNECT = 1, MSG_CREATE = 2, MSG_SEAL = 3, MSG_GET = 4,
                  MSG_RELEASE = 5, MSG_CONTAINS = 6, MSG_DELETE = 7,
                  MSG_METRICS = 8, MSG_ABORT = 9, MSG_LIST = 10;
constexpr int32_t ST_OK = 0, ST_FULL = -1, ST_EXISTS = -2, ST_NOT_FOUND = -3,
                  ST_NOT_SEALED = -4, ST_TIMEOUT = -5, ST_IN_USE = -6;

struct ObjectId {
  char b[kIdSize];
  bool operator==(const ObjectId& o) const { return memcmp(b, o.b, kIdSize) == 0; }
};
struct IdHash {
  size_t operator()(const ObjectId& id) const {
    size_t h;
    memcpy(&h, id.b, sizeof(h));
    return h;
  }
};

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

// ---------------------------------------------------------------------------
// Best-fit free-list allocator with address-ordered coalescing over one pool.
// Fills the role of plasma's dlmalloc-over-mmap (plasma/dlmalloc.cc).
// ---------------------------------------------------------------------------
class PoolAllocator {
 public:
  explicit PoolAllocator(size_t capacity) : capacity_(capacity) {
    free_by_addr_[0] = capacity;
  }

  static constexpr size_t kAlign = 64;  // cacheline; also matches TPU DMA
                                        // friendly host alignment

  bool Alloc(size_t size, size_t* out_off) {
    size = (size + kAlign - 1) & ~(kAlign - 1);
    if (size == 0) size = kAlign;
    // best fit scan
    auto best = free_by_addr_.end();
    size_t best_sz = SIZE_MAX;
    for (auto it = free_by_addr_.begin(); it != free_by_addr_.end(); ++it) {
      if (it->second >= size && it->second < best_sz) {
        best = it;
        best_sz = it->second;
        if (best_sz == size) break;
      }
    }
    if (best == free_by_addr_.end()) return false;
    size_t off = best->first;
    size_t blk = best->second;
    free_by_addr_.erase(best);
    if (blk > size) free_by_addr_[off + size] = blk - size;
    allocated_ += size;
    sizes_[off] = size;
    if (out_off) *out_off = off;
    return true;
  }

  void Free(size_t off) {
    auto it = sizes_.find(off);
    if (it == sizes_.end()) return;
    size_t size = it->second;
    sizes_.erase(it);
    allocated_ -= size;
    // coalesce with next
    auto next = free_by_addr_.find(off + size);
    if (next != free_by_addr_.end()) {
      size += next->second;
      free_by_addr_.erase(next);
    }
    // coalesce with prev
    auto ub = free_by_addr_.upper_bound(off);
    if (ub != free_by_addr_.begin()) {
      auto prev = std::prev(ub);
      if (prev->first + prev->second == off) {
        prev->second += size;
        return;
      }
    }
    free_by_addr_[off] = size;
  }

  size_t allocated() const { return allocated_; }
  size_t capacity() const { return capacity_; }

 private:
  size_t capacity_;
  size_t allocated_ = 0;
  std::map<size_t, size_t> free_by_addr_;           // offset -> size
  std::unordered_map<size_t, size_t> sizes_;        // offset -> alloc size
};

// ---------------------------------------------------------------------------
// Object table + LRU eviction (plasma: object_lifecycle_manager.h,
// eviction_policy.h LRUCache).
// ---------------------------------------------------------------------------
enum class ObjState { CREATED, SEALED };

struct Entry {
  size_t offset = 0;
  uint64_t size = 0;
  ObjState state = ObjState::CREATED;
  int refcount = 0;  // client Get() pins
  int creator_fd = -1;
  std::list<ObjectId>::iterator lru_it;
  bool in_lru = false;
  // DELETE arrived while pinned: drop the object when the last pin is
  // released (plasma semantics — buffers outlive the delete request)
  bool pending_delete = false;
};

struct PendingGet {
  int client_fd;
  std::vector<ObjectId> ids;
  uint64_t deadline_ms;  // 0 = no timeout
  bool done = false;
};

class Store;

struct Client {
  int fd;
  std::string inbuf;
  std::string outbuf;
  std::unordered_map<ObjectId, int, IdHash> pins;  // per-client refcounts
};

class Store {
 public:
  Store(size_t capacity, int pool_fd, uint8_t* base, bool no_evict)
      : alloc_(capacity), pool_fd_(pool_fd), base_(base), no_evict_(no_evict) {}

  PoolAllocator alloc_;
  int pool_fd_;
  uint8_t* base_;
  bool no_evict_;
  std::unordered_map<ObjectId, Entry, IdHash> objects_;
  std::list<ObjectId> lru_;  // front = most recent
  std::deque<std::shared_ptr<PendingGet>> waiting_gets_;
  uint64_t num_evictions_ = 0;
  uint64_t bytes_evicted_ = 0;

  void Touch(const ObjectId& id, Entry& e) {
    if (e.in_lru) lru_.erase(e.lru_it);
    lru_.push_front(id);
    e.lru_it = lru_.begin();
    e.in_lru = true;
  }

  // Evict LRU sealed, unpinned objects until `needed` bytes can be allocated.
  bool EvictUntil(size_t needed) {
    while (true) {
      size_t off;
      if (alloc_.Alloc(needed, &off)) {
        alloc_.Free(off);  // probe only
        return true;
      }
      if (no_evict_) return false;  // caller spills via the raylet instead
      // find eviction victim from LRU tail
      bool evicted = false;
      for (auto it = lru_.rbegin(); it != lru_.rend(); ++it) {
        auto oit = objects_.find(*it);
        if (oit == objects_.end()) continue;
        Entry& e = oit->second;
        if (e.state == ObjState::SEALED && e.refcount == 0) {
          num_evictions_++;
          bytes_evicted_ += e.size;
          alloc_.Free(e.offset);
          lru_.erase(std::next(it).base());
          objects_.erase(oit);
          evicted = true;
          break;
        }
      }
      if (!evicted) return false;
    }
  }
};

// ---------------------------------------------------------------------------
// Wire helpers
// ---------------------------------------------------------------------------
void put_u32(std::string& s, uint32_t v) { s.append((char*)&v, 4); }
void put_u64(std::string& s, uint64_t v) { s.append((char*)&v, 8); }
void put_i32(std::string& s, int32_t v) { s.append((char*)&v, 4); }
void put_u8(std::string& s, uint8_t v) { s.append((char*)&v, 1); }

void frame_reply(Client& c, uint8_t type, const std::string& payload) {
  uint32_t len = payload.size();
  c.outbuf.append((char*)&len, 4);
  c.outbuf.push_back((char)type);
  c.outbuf.append(payload);
}

int send_fd(int sock, const void* data, size_t len, int fd) {
  struct msghdr msg;
  memset(&msg, 0, sizeof(msg));
  struct iovec iov = {const_cast<void*>(data), len};
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  char cmsgbuf[CMSG_SPACE(sizeof(int))];
  msg.msg_control = cmsgbuf;
  msg.msg_controllen = sizeof(cmsgbuf);
  struct cmsghdr* cmsg = CMSG_FIRSTHDR(&msg);
  cmsg->cmsg_level = SOL_SOCKET;
  cmsg->cmsg_type = SCM_RIGHTS;
  cmsg->cmsg_len = CMSG_LEN(sizeof(int));
  memcpy(CMSG_DATA(cmsg), &fd, sizeof(int));
  return sendmsg(sock, &msg, 0);
}

// ---------------------------------------------------------------------------
// Server
// ---------------------------------------------------------------------------
class Server {
 public:
  Server(const std::string& sock_path, size_t capacity, bool no_evict)
      : sock_path_(sock_path), capacity_(capacity), no_evict_(no_evict) {}

  int Run() {
    // shm pool
    int pool_fd = memfd_create("ray_tpu_pool", MFD_CLOEXEC);
    if (pool_fd < 0) {
      perror("memfd_create");
      return 1;
    }
    if (ftruncate(pool_fd, capacity_) != 0) {
      perror("ftruncate");
      return 1;
    }
    uint8_t* base = (uint8_t*)mmap(nullptr, capacity_, PROT_READ | PROT_WRITE,
                                   MAP_SHARED, pool_fd, 0);
    if (base == MAP_FAILED) {
      perror("mmap");
      return 1;
    }
    store_ = std::make_unique<Store>(capacity_, pool_fd, base, no_evict_);

    // listening socket
    unlink(sock_path_.c_str());
    listen_fd_ = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, sock_path_.c_str(), sizeof(addr.sun_path) - 1);
    if (bind(listen_fd_, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
      perror("bind");
      return 1;
    }
    listen(listen_fd_, 128);

    epfd_ = epoll_create1(EPOLL_CLOEXEC);
    AddEpoll(listen_fd_, EPOLLIN);
    fprintf(stderr, "[ray_tpu_store] ready capacity=%zu socket=%s\n", capacity_,
            sock_path_.c_str());
    fflush(stderr);

    std::vector<struct epoll_event> events(64);
    while (true) {
      int timeout = NextTimeoutMs();
      int n = epoll_wait(epfd_, events.data(), events.size(), timeout);
      if (n < 0) {
        if (errno == EINTR) continue;
        perror("epoll_wait");
        break;
      }
      for (int i = 0; i < n; i++) {
        int fd = events[i].data.fd;
        if (fd == listen_fd_) {
          Accept();
        } else {
          auto it = clients_.find(fd);
          if (it == clients_.end()) continue;
          if (events[i].events & (EPOLLHUP | EPOLLERR)) {
            Disconnect(fd);
            continue;
          }
          if (events[i].events & EPOLLIN) {
            if (!ReadClient(*it->second)) {
              Disconnect(fd);
              continue;
            }
          }
          if (events[i].events & EPOLLOUT) FlushClient(*it->second);
        }
      }
      ExpireGets();
    }
    return 0;
  }

 private:
  void AddEpoll(int fd, uint32_t ev) {
    struct epoll_event e;
    e.events = ev;
    e.data.fd = fd;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &e);
  }
  void ModEpoll(int fd, uint32_t ev) {
    struct epoll_event e;
    e.events = ev;
    e.data.fd = fd;
    epoll_ctl(epfd_, EPOLL_CTL_MOD, fd, &e);
  }

  void Accept() {
    while (true) {
      int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) break;
      auto c = std::make_unique<Client>();
      c->fd = fd;
      AddEpoll(fd, EPOLLIN);
      clients_[fd] = std::move(c);
    }
  }

  void Disconnect(int fd) {
    auto it = clients_.find(fd);
    if (it == clients_.end()) return;
    Client& c = *it->second;
    // release this client's pins; abort its unsealed creates
    for (auto& [id, cnt] : c.pins) {
      auto oit = store_->objects_.find(id);
      if (oit == store_->objects_.end()) continue;
      oit->second.refcount -= cnt;
      if (oit->second.refcount <= 0 && oit->second.pending_delete) {
        store_->alloc_.Free(oit->second.offset);
        if (oit->second.in_lru) store_->lru_.erase(oit->second.lru_it);
        store_->objects_.erase(oit);
      }
    }
    std::vector<ObjectId> to_abort;
    for (auto& [id, e] : store_->objects_) {
      if (e.state == ObjState::CREATED && e.creator_fd == fd) to_abort.push_back(id);
    }
    for (auto& id : to_abort) {
      auto oit = store_->objects_.find(id);
      store_->alloc_.Free(oit->second.offset);
      if (oit->second.in_lru) store_->lru_.erase(oit->second.lru_it);
      store_->objects_.erase(oit);
    }
    for (auto& pg : store_->waiting_gets_)
      if (pg->client_fd == fd) pg->done = true;
    Compact();
    epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    clients_.erase(it);
  }

  bool ReadClient(Client& c) {
    char buf[65536];
    while (true) {
      ssize_t r = recv(c.fd, buf, sizeof(buf), 0);
      if (r > 0) {
        c.inbuf.append(buf, r);
      } else if (r == 0) {
        return false;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        return false;
      }
    }
    // process complete frames
    size_t off = 0;
    while (c.inbuf.size() - off >= 5) {
      uint32_t len;
      memcpy(&len, c.inbuf.data() + off, 4);
      if (c.inbuf.size() - off < 5 + len) break;
      uint8_t type = c.inbuf[off + 4];
      HandleMessage(c, type, c.inbuf.data() + off + 5, len);
      off += 5 + len;
    }
    c.inbuf.erase(0, off);
    FlushClient(c);
    return true;
  }

  void FlushClient(Client& c) {
    while (!c.outbuf.empty()) {
      ssize_t w = send(c.fd, c.outbuf.data(), c.outbuf.size(), MSG_NOSIGNAL);
      if (w > 0) {
        c.outbuf.erase(0, w);
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          ModEpoll(c.fd, EPOLLIN | EPOLLOUT);
          return;
        }
        return;  // will be cleaned up on next event
      }
    }
    ModEpoll(c.fd, EPOLLIN);
  }

  void HandleMessage(Client& c, uint8_t type, const char* p, uint32_t len) {
    switch (type) {
      case MSG_CONNECT: {
        std::string payload;
        put_u64(payload, capacity_);
        // reply frame sent synchronously with the pool fd attached
        std::string frame;
        uint32_t plen = payload.size();
        frame.append((char*)&plen, 4);
        frame.push_back((char)MSG_CONNECT);
        frame.append(payload);
        send_fd(c.fd, frame.data(), frame.size(), store_->pool_fd_);
        break;
      }
      case MSG_CREATE: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        uint64_t size;
        memcpy(&size, p + kIdSize, 8);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it != store_->objects_.end()) {
          put_i32(payload, ST_EXISTS);
          put_u64(payload, 0);
        } else if (size > capacity_) {
          put_i32(payload, ST_FULL);
          put_u64(payload, 0);
        } else {
          if (!store_->EvictUntil(size)) {
            put_i32(payload, ST_FULL);
            put_u64(payload, 0);
          } else {
            size_t offset;
            store_->alloc_.Alloc(size, &offset);
            Entry e;
            e.offset = offset;
            e.size = size;
            e.state = ObjState::CREATED;
            e.creator_fd = c.fd;
            auto [nit, _] = store_->objects_.emplace(id, e);
            store_->Touch(id, nit->second);
            put_i32(payload, ST_OK);
            put_u64(payload, offset);
          }
        }
        frame_reply(c, MSG_CREATE, payload);
        break;
      }
      case MSG_SEAL: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it == store_->objects_.end()) {
          put_i32(payload, ST_NOT_FOUND);
        } else {
          it->second.state = ObjState::SEALED;
          put_i32(payload, ST_OK);
          WakeGetsFor(id);
        }
        frame_reply(c, MSG_SEAL, payload);
        break;
      }
      case MSG_GET: {
        uint32_t n;
        memcpy(&n, p, 4);
        auto pg = std::make_shared<PendingGet>();
        pg->client_fd = c.fd;
        pg->ids.resize(n);
        for (uint32_t i = 0; i < n; i++)
          memcpy(pg->ids[i].b, p + 4 + i * kIdSize, kIdSize);
        int64_t timeout_ms;
        memcpy(&timeout_ms, p + 4 + n * kIdSize, 8);
        pg->deadline_ms = timeout_ms < 0 ? 0 : now_ms() + timeout_ms;
        if (AllSealed(*pg)) {
          ReplyGet(c, *pg, false);
        } else if (timeout_ms == 0) {
          ReplyGet(c, *pg, true);  // immediate, TIMEOUT for unsealed
        } else {
          store_->waiting_gets_.push_back(pg);
        }
        break;
      }
      case MSG_RELEASE: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it == store_->objects_.end()) {
          put_i32(payload, ST_NOT_FOUND);
        } else {
          if (it->second.refcount > 0) it->second.refcount--;
          auto pit = c.pins.find(id);
          if (pit != c.pins.end() && --pit->second <= 0) c.pins.erase(pit);
          if (it->second.refcount == 0 && it->second.pending_delete) {
            store_->alloc_.Free(it->second.offset);
            if (it->second.in_lru) store_->lru_.erase(it->second.lru_it);
            store_->objects_.erase(it);
          }
          put_i32(payload, ST_OK);
        }
        frame_reply(c, MSG_RELEASE, payload);
        break;
      }
      case MSG_CONTAINS: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it == store_->objects_.end())
          put_i32(payload, 2);
        else
          put_i32(payload, it->second.state == ObjState::SEALED ? 0 : 1);
        frame_reply(c, MSG_CONTAINS, payload);
        break;
      }
      case MSG_DELETE: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it == store_->objects_.end()) {
          put_i32(payload, ST_NOT_FOUND);
        } else if (it->second.refcount > 0) {
          it->second.pending_delete = true;  // applied on last release
          put_i32(payload, ST_IN_USE);
        } else {
          store_->alloc_.Free(it->second.offset);
          if (it->second.in_lru) store_->lru_.erase(it->second.lru_it);
          store_->objects_.erase(it);
          put_i32(payload, ST_OK);
        }
        frame_reply(c, MSG_DELETE, payload);
        break;
      }
      case MSG_ABORT: {
        ObjectId id;
        memcpy(id.b, p, kIdSize);
        std::string payload;
        auto it = store_->objects_.find(id);
        if (it == store_->objects_.end() || it->second.state == ObjState::SEALED) {
          put_i32(payload, ST_NOT_FOUND);
        } else {
          store_->alloc_.Free(it->second.offset);
          if (it->second.in_lru) store_->lru_.erase(it->second.lru_it);
          store_->objects_.erase(it);
          put_i32(payload, ST_OK);
        }
        frame_reply(c, MSG_ABORT, payload);
        break;
      }
      case MSG_LIST: {
        // LRU tail first (oldest → best spill candidates)
        std::string body;
        uint32_t listed = 0;
        for (auto it = store_->lru_.rbegin(); it != store_->lru_.rend(); ++it) {
          auto oit = store_->objects_.find(*it);
          if (oit == store_->objects_.end()) continue;
          body.append(it->b, kIdSize);
          put_u64(body, oit->second.size);
          put_u8(body, oit->second.state == ObjState::SEALED ? 1 : 0);
          put_u8(body, oit->second.refcount > 0 ? 1 : 0);
          listed++;
        }
        std::string payload;
        put_u32(payload, listed);
        payload.append(body);
        frame_reply(c, MSG_LIST, payload);
        break;
      }
      case MSG_METRICS: {
        std::string payload;
        put_u64(payload, capacity_);
        put_u64(payload, store_->alloc_.allocated());
        put_u64(payload, store_->objects_.size());
        put_u64(payload, store_->num_evictions_);
        put_u64(payload, store_->bytes_evicted_);
        frame_reply(c, MSG_METRICS, payload);
        break;
      }
      default:
        break;
    }
  }

  bool AllSealed(const PendingGet& pg) {
    for (auto& id : pg.ids) {
      auto it = store_->objects_.find(id);
      if (it == store_->objects_.end() || it->second.state != ObjState::SEALED)
        return false;
    }
    return true;
  }

  void ReplyGet(Client& c, PendingGet& pg, bool allow_missing) {
    std::string payload;
    put_u32(payload, pg.ids.size());
    for (auto& id : pg.ids) {
      auto it = store_->objects_.find(id);
      if (it != store_->objects_.end() && it->second.state == ObjState::SEALED) {
        Entry& e = it->second;
        e.refcount++;
        c.pins[id]++;
        store_->Touch(id, e);
        put_i32(payload, ST_OK);
        put_u64(payload, e.offset);
        put_u64(payload, e.size);
      } else {
        put_i32(payload, ST_TIMEOUT);
        put_u64(payload, 0);
        put_u64(payload, 0);
      }
    }
    frame_reply(c, MSG_GET, payload);
    pg.done = true;
  }

  void WakeGetsFor(const ObjectId& id) {
    for (auto& pg : store_->waiting_gets_) {
      if (pg->done) continue;
      bool relevant = false;
      for (auto& i : pg->ids)
        if (i == id) {
          relevant = true;
          break;
        }
      if (relevant && AllSealed(*pg)) {
        auto cit = clients_.find(pg->client_fd);
        if (cit != clients_.end()) {
          ReplyGet(*cit->second, *pg, false);
          FlushClient(*cit->second);
        } else {
          pg->done = true;
        }
      }
    }
    Compact();
  }

  void ExpireGets() {
    uint64_t now = now_ms();
    for (auto& pg : store_->waiting_gets_) {
      if (pg->done) continue;
      if (pg->deadline_ms != 0 && now >= pg->deadline_ms) {
        auto cit = clients_.find(pg->client_fd);
        if (cit != clients_.end()) {
          ReplyGet(*cit->second, *pg, true);
          FlushClient(*cit->second);
        } else {
          pg->done = true;
        }
      }
    }
    Compact();
  }

  void Compact() {
    // erase done entries anywhere in the deque: one stuck no-timeout get at
    // the front must not pin every later completed entry
    auto& wg = store_->waiting_gets_;
    wg.erase(std::remove_if(wg.begin(), wg.end(),
                            [](const std::shared_ptr<PendingGet>& pg) { return pg->done; }),
             wg.end());
  }

  int NextTimeoutMs() {
    uint64_t now = now_ms();
    int64_t best = -1;
    for (auto& pg : store_->waiting_gets_) {
      if (pg->done || pg->deadline_ms == 0) continue;
      int64_t d = (int64_t)pg->deadline_ms - (int64_t)now;
      if (d < 0) d = 0;
      if (best < 0 || d < best) best = d;
    }
    return best < 0 ? 1000 : (int)best;
  }

  std::string sock_path_;
  size_t capacity_;
  bool no_evict_ = false;
  int listen_fd_ = -1;
  int epfd_ = -1;
  std::unique_ptr<Store> store_;
  std::unordered_map<int, std::unique_ptr<Client>> clients_;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <socket_path> <capacity_bytes> [no-evict]\n",
            argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  bool no_evict = argc > 3 && strcmp(argv[3], "no-evict") == 0;
  Server server(argv[1], strtoull(argv[2], nullptr, 10), no_evict);
  return server.Run();
}
