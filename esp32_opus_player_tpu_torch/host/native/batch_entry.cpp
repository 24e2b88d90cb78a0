// Batched host symbol phase: decode N streams' frames in ONE library
// call. The per-frame engines (celt_host.cpp / silk_host.cpp) stay the
// unit of correctness; this TU only adds strip-mined fan-out so that
//   (a) Python/ctypes overhead is paid once per STEP, not once per frame
//       (the GIL is released for the whole batch), and
//   (b) the loop scales across host cores with std::thread strips —
//       each stream's decoder state is independent, so rows never race.
//
// The reference decodes one stream on one core (src/main.cpp decode
// task); this is the N-streams-per-step equivalent the TPU pool needs
// (SURVEY.md §2.7 stream-batch data parallelism, host half).
//
// Each entry also times its strips: wall (steady_clock) and CPU
// (CLOCK_THREAD_CPUTIME_ID) per strip, and its own wall. The calling
// thread reads the last entry's with host_batch_last_strips and the sums
// since its last read with host_batch_take_strips (thread-local: a
// thread reads what its own calls did).
#include <time.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <thread>
#include <vector>

using i16 = int16_t;
using i32 = int32_t;
using i64 = int64_t;
using u8 = unsigned char;

extern "C" {
// per-frame engines (exported by celt_host.cpp / silk_host.cpp); decoder
// states are opaque here — callers pass byte pointers + stride
int celt_host_decode_resume(const u8* data, int len, int frame_size,
                            int CC, int C, int start, int end,
                            int disable_inv, void* st, i16* X_out,
                            i16* bandE_out, i32* out_params,
                            const i32* ec_in);
int silk_host_frame_c(const u8* data, int len, int fs_khz, int payload_ms,
                      int hybrid, void* st, i32* exc, i32* A, i32* B,
                      i32* gains, i32* inv, i32* lag, i32* flags, i32* adj,
                      i32* ec, i32* misc);
int silk_host_packet_c(const u8* data, int len, int fs_khz, int payload_ms,
                       void* st, i32* exc, i32* A, i32* B, i32* gains,
                       i32* inv, i32* lag, i32* flags, i32* adj, i32* misc);
int silk_host_stereo_c(const u8* data, int len, int fs_khz,
                       int payload_ms, int prev_dom,
                       int hybrid, void* st0, void* st1,
                       i32* m_exc, i32* m_A, i32* m_B, i32* m_gains,
                       i32* m_inv, i32* m_lag, i32* m_flags, i32* m_adj,
                       i32* m_misc,
                       i32* s_exc, i32* s_A, i32* s_B, i32* s_gains,
                       i32* s_inv, i32* s_lag, i32* s_flags, i32* s_adj,
                       i32* s_misc, i32* ec, i32* info);
}

namespace {

double cpu_now() {
    timespec ts;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

double wall_since(std::chrono::steady_clock::time_point t0) {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
}

// the calling thread's strip times: the last entry's strips and its
// wall, and since the last take: strips, CPU s, entry wall s, and the
// sum of strips x entry wall
thread_local std::vector<double> last_wall, last_cpu;
thread_local double last_entry = 0.0;
thread_local double taken[4] = {0.0, 0.0, 0.0, 0.0};

// run fn(i) for i in [0, n) over T = min(n_threads, n) strips (one strip
// on the calling thread when n_threads <= 1 or n < 2), timing each strip
template <typename F>
void strip_for(int n, int n_threads, F fn) {
    auto e0 = std::chrono::steady_clock::now();
    int T = (n_threads <= 1 || n < 2) ? std::min(n, 1)
                                      : std::min(n_threads, n);
    std::vector<double> wall(T), cpu(T);
    auto run = [&](int t) {
        auto w0 = std::chrono::steady_clock::now();
        double c0 = cpu_now();
        int lo = (int)((i64)n * t / T), hi = (int)((i64)n * (t + 1) / T);
        for (int i = lo; i < hi; i++) fn(i);
        cpu[t] = cpu_now() - c0;
        wall[t] = wall_since(w0);
    };
    std::vector<std::thread> ts;
    ts.reserve(std::max(T - 1, 0));
    for (int t = 1; t < T; t++) ts.emplace_back(run, t);
    if (T > 0) run(0);
    for (auto& th : ts) th.join();
    double entry = wall_since(e0), cpu_sum = 0.0;
    for (double c : cpu) cpu_sum += c;
    taken[0] += T;
    taken[1] += cpu_sum;
    taken[2] += entry;
    taken[3] += T * entry;
    last_wall.swap(wall);
    last_cpu.swap(cpu);
    last_entry = entry;
}

}  // namespace

extern "C" {

// The last batch entry this thread called: its strips' wall and CPU
// seconds (up to cap of them) and its own wall seconds. Returns the
// number of strips, T.
int host_batch_last_strips(double* wall, double* cpu, int cap,
                           double* entry_wall) {
    int T = (int)last_wall.size();
    for (int t = 0; t < T && t < cap; t++) {
        wall[t] = last_wall[t];
        cpu[t] = last_cpu[t];
    }
    *entry_wall = last_entry;
    return T;
}

// The sums over the batch entries this thread called since its last
// take, into out[4]: strips, strip CPU s, entry wall s, strips x entry
// wall s; then zero them.
void host_batch_take_strips(double* out) {
    for (int k = 0; k < 4; k++) {
        out[k] = taken[k];
        taken[k] = 0.0;
    }
}

// Batched CELT symbol phase. Row i decodes blob[offs[i] .. offs[i]+
// lens[i]) with per-row start/end bands into row i of the output
// tensors; rows with lens[i] < 0 are skipped (ret_out = 1). ec_in (n*9)
// resumes hybrid rows mid-packet; pass NULL for fresh packets.
void celt_host_decode_batch(int n, const u8* blob, const i64* offs,
                            const i32* lens, int frame_size, int CC, int C,
                            const i32* start, const i32* end,
                            int disable_inv, u8* states, i64 state_stride,
                            const i32* ec_in, i16* X_out, i16* bandE_out,
                            i32* params_out, i32* ret_out, int n_threads) {
    const i64 xw = (i64)C * frame_size;
    strip_for(n, n_threads, [&](int i) {
        if (lens[i] < 0) { ret_out[i] = 1; return; }
        ret_out[i] = celt_host_decode_resume(
            blob + offs[i], lens[i], frame_size, CC, C, start[i], end[i],
            disable_inv, states + (i64)i * state_stride, X_out + i * xw,
            bandE_out + (i64)i * 42, params_out + (i64)i * 18,
            ec_in ? ec_in + (i64)i * 9 : nullptr);
    });
}

// Batched mono SILK symbol phase, one internal frame per row (10/20 ms
// payloads). hybrid=1 also consumes the redundancy flag and exports the
// range-coder state (ec n*9) for the CELT resume batch.
void silk_host_frame_batch(int n, const u8* blob, const i64* offs,
                           const i32* lens, int fs_khz, int payload_ms,
                           int hybrid, u8* states, i64 state_stride,
                           i32* exc, i32* A, i32* B, i32* gains, i32* inv,
                           i32* lag, i32* flags, i32* adj, i32* ec,
                           i32* misc, i32* ret_out, int n_threads) {
    const i64 fl = (i64)payload_ms * fs_khz;
    strip_for(n, n_threads, [&](int i) {
        if (lens[i] < 0) { ret_out[i] = 1; return; }
        ret_out[i] = silk_host_frame_c(
            blob + offs[i], lens[i], fs_khz, payload_ms, hybrid,
            states + (i64)i * state_stride, exc + i * fl,
            A + (i64)i * 32, B + (i64)i * 20, gains + (i64)i * 4,
            inv + (i64)i * 4, lag + (i64)i * 4, flags + (i64)i * 12,
            adj + (i64)i * 4, ec + (i64)i * 9, misc + (i64)i * 24);
    });
}

// Batched mono SILK 40/60 ms packets: nfr = payload_ms/20 internal
// frames per row; outputs are (n, nfr, ...) C-contiguous.
void silk_host_packet_batch(int n, const u8* blob, const i64* offs,
                            const i32* lens, int fs_khz, int payload_ms,
                            u8* states, i64 state_stride,
                            i32* exc, i32* A, i32* B, i32* gains, i32* inv,
                            i32* lag, i32* flags, i32* adj, i32* misc,
                            i32* ret_out, int n_threads) {
    const i64 nfr = payload_ms / 20;
    const i64 fl = (i64)20 * fs_khz * nfr;
    strip_for(n, n_threads, [&](int i) {
        if (lens[i] < 0) { ret_out[i] = 1; return; }
        ret_out[i] = silk_host_packet_c(
            blob + offs[i], lens[i], fs_khz, payload_ms,
            states + (i64)i * state_stride, exc + i * fl,
            A + i * nfr * 32, B + i * nfr * 20, gains + i * nfr * 4,
            inv + i * nfr * 4, lag + i * nfr * 4, flags + i * nfr * 12,
            adj + i * nfr * 4, misc + i * nfr * 24);
    });
}

// Batched STEREO SILK symbol phase (single-frame packets: payload_ms
// 10 -> nb_subfr 2, 20 -> nb_subfr 4). states holds n interleaved
// (mid, side) state pairs: row i's channel c state lives at
// states + (2*i + c) * state_stride. prev_dom is per-row in/out via
// info[i*8+2] (prev_decode_only_middle, silk_Decode :459).
void silk_host_stereo_batch(int n, const u8* blob, const i64* offs,
                            const i32* lens, int fs_khz, int payload_ms,
                            const i32* prev_dom, int hybrid, u8* states,
                            i64 state_stride,
                            i32* m_exc, i32* m_A, i32* m_B, i32* m_gains,
                            i32* m_inv, i32* m_lag, i32* m_flags,
                            i32* m_adj, i32* m_misc,
                            i32* s_exc, i32* s_A, i32* s_B, i32* s_gains,
                            i32* s_inv, i32* s_lag, i32* s_flags,
                            i32* s_adj, i32* s_misc,
                            i32* ec, i32* info, i32* ret_out,
                            int n_threads) {
    const i64 fl = (i64)payload_ms * fs_khz;
    strip_for(n, n_threads, [&](int i) {
        if (lens[i] < 0) { ret_out[i] = 1; return; }
        ret_out[i] = silk_host_stereo_c(
            blob + offs[i], lens[i], fs_khz, payload_ms, prev_dom[i],
            hybrid,
            states + (i64)(2 * i) * state_stride,
            states + (i64)(2 * i + 1) * state_stride,
            m_exc + i * fl, m_A + (i64)i * 32, m_B + (i64)i * 20,
            m_gains + (i64)i * 4, m_inv + (i64)i * 4, m_lag + (i64)i * 4,
            m_flags + (i64)i * 12, m_adj + (i64)i * 4, m_misc + (i64)i * 24,
            s_exc + i * fl, s_A + (i64)i * 32, s_B + (i64)i * 20,
            s_gains + (i64)i * 4, s_inv + (i64)i * 4, s_lag + (i64)i * 4,
            s_flags + (i64)i * 12, s_adj + (i64)i * 4, s_misc + (i64)i * 24,
            ec + (i64)i * 9, info + (i64)i * 8);
    });
}

}  // extern "C"
