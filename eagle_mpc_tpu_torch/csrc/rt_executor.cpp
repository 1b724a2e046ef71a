// Real-time MPC executor: drift-free periodic scheduling + telemetry ring.
//
// Native runtime layer for closed-loop MPC serving (the PyTorch port's
// copy; eagle_mpc_tpu_torch/utils/rt_executor.py builds and binds it). The
// reference demo times its control loop with ad-hoc wall-clock deltas and
// prints AVG/STDDEV/MAX/MIN per step; this module is the production
// version of that idea:
//
//  - absolute-deadline periodic scheduling (clock_nanosleep TIMER_ABSTIME):
//    no drift accumulation, lateness measured per tick;
//  - deadline-miss accounting against a configurable compute budget;
//  - a lock-free single-producer telemetry ring buffer (update time, solve
//    time, cost, iterations per tick) with streaming statistics.
//
// Exposed through a minimal C ABI consumed from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

constexpr clockid_t kClock = CLOCK_MONOTONIC;

double now_s() {
    timespec ts;
    clock_gettime(kClock, &ts);
    return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

timespec to_timespec(double t) {
    timespec ts;
    ts.tv_sec = time_t(t);
    ts.tv_nsec = long((t - double(ts.tv_sec)) * 1e9);
    if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec += 1;
        ts.tv_nsec -= 1000000000L;
    }
    return ts;
}

struct Stream {
    // numerically stable streaming mean/variance (Welford)
    uint64_t n = 0;
    double mean = 0.0, m2 = 0.0;
    double mn = 1e300, mx = -1e300;

    void push(double x) {
        ++n;
        const double d = x - mean;
        mean += d / double(n);
        m2 += d * (x - mean);
        mn = std::min(mn, x);
        mx = std::max(mx, x);
    }
    double stddev() const { return n > 1 ? std::sqrt(m2 / double(n - 1)) : 0.0; }
};

struct TickRecord {
    uint64_t tick;
    double update_s, solve_s, cost;
    int32_t iters;
};

struct Executor {
    double period_s;
    double budget_s;
    double next_deadline = 0.0;
    uint64_t tick = 0;
    uint64_t misses = 0;

    Stream update_st, solve_st, lateness_st, total_st;

    std::vector<TickRecord> ring;
    size_t ring_cap;
    std::atomic<uint64_t> ring_head{0};

    explicit Executor(double period, double budget, size_t cap)
        : period_s(period), budget_s(budget > 0 ? budget : period),
          ring(cap), ring_cap(cap) {}
};

}  // namespace

extern "C" {

void* rte_create(double period_s, double budget_s, int ring_capacity) {
    if (period_s <= 0 || ring_capacity <= 0) return nullptr;
    return new Executor(period_s, budget_s, size_t(ring_capacity));
}

void rte_destroy(void* h) { delete static_cast<Executor*>(h); }

double rte_now() { return now_s(); }

void rte_start(void* h) {
    auto* e = static_cast<Executor*>(h);
    e->next_deadline = now_s() + e->period_s;
}

// Sleep until the next absolute deadline; returns lateness in seconds
// (>0 means the previous tick overran its slot). Advances the deadline by
// whole periods so a long overrun does not cause a burst of catch-up ticks.
double rte_wait_next(void* h) {
    auto* e = static_cast<Executor*>(h);
    const double t = now_s();
    double lateness = t - e->next_deadline;
    if (lateness < 0) {
        timespec ts = to_timespec(e->next_deadline);
        while (clock_nanosleep(kClock, TIMER_ABSTIME, &ts, nullptr) != 0) {
        }
        lateness = 0.0;
        e->next_deadline += e->period_s;
    } else {
        // missed: skip forward to the next future slot
        const double k = std::ceil(lateness / e->period_s);
        e->next_deadline += (k + 1.0) * e->period_s;
    }
    e->lateness_st.push(lateness);
    return lateness;
}

void rte_record(void* h, double update_s, double solve_s, double cost,
                int iters) {
    auto* e = static_cast<Executor*>(h);
    const double total = update_s + solve_s;
    e->update_st.push(update_s);
    e->solve_st.push(solve_s);
    e->total_st.push(total);
    if (total > e->budget_s) ++e->misses;

    const uint64_t head = e->ring_head.load(std::memory_order_relaxed);
    TickRecord& r = e->ring[head % e->ring_cap];
    r.tick = e->tick;
    r.update_s = update_s;
    r.solve_s = solve_s;
    r.cost = cost;
    r.iters = iters;
    e->ring_head.store(head + 1, std::memory_order_release);
    ++e->tick;
}

// out[16]: n, upd avg/std/max/min, solve avg/std/max/min,
//          total avg/max, lateness avg/max, misses, period, budget
void rte_stats(void* h, double* out) {
    auto* e = static_cast<Executor*>(h);
    const Stream& u = e->update_st;
    const Stream& s = e->solve_st;
    out[0] = double(u.n);
    out[1] = u.mean; out[2] = u.stddev();
    out[3] = u.n ? u.mx : 0.0; out[4] = u.n ? u.mn : 0.0;
    out[5] = s.mean; out[6] = s.stddev();
    out[7] = s.n ? s.mx : 0.0; out[8] = s.n ? s.mn : 0.0;
    out[9] = e->total_st.mean;
    out[10] = e->total_st.n ? e->total_st.mx : 0.0;
    out[11] = e->lateness_st.mean;
    out[12] = e->lateness_st.n ? e->lateness_st.mx : 0.0;
    out[13] = double(e->misses);
    out[14] = e->period_s;
    out[15] = e->budget_s;
}

// Copy up to max_n most recent records as flat doubles
// [tick, update_s, solve_s, cost, iters] per row; returns rows written.
int rte_history(void* h, double* out, int max_n) {
    auto* e = static_cast<Executor*>(h);
    const uint64_t head = e->ring_head.load(std::memory_order_acquire);
    const uint64_t avail = std::min<uint64_t>(head, e->ring_cap);
    const int n = int(std::min<uint64_t>(avail, uint64_t(max_n)));
    for (int i = 0; i < n; ++i) {
        const TickRecord& r = e->ring[(head - n + i) % e->ring_cap];
        out[i * 5 + 0] = double(r.tick);
        out[i * 5 + 1] = r.update_s;
        out[i * 5 + 2] = r.solve_s;
        out[i * 5 + 3] = r.cost;
        out[i * 5 + 4] = double(r.iters);
    }
    return n;
}

}  // extern "C"
