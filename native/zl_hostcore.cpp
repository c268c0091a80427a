/*
 * zl_hostcore.cpp — native implementation of the per-block voice update.
 *
 * The block scheduler's hottest host path is the voice machine
 * (libzl_tpu/engine/voicestate.py): converting per-voice state into the
 * device program (position segments, loop-wrap schedules, envelope programs,
 * stop/release frames) and mirroring state past the block. The numpy
 * implementation is vectorized but overhead-bound (~100 array ops per
 * block, ~1.6 ms at 1024 voices); this C++ core does the same math in one
 * pass over the voices (~tens of microseconds), the way the reference keeps
 * its scheduler core native (lib/SyncTimer.cpp's process loop).
 *
 * The Python VoicePool remains the owner of all state arrays; this library
 * receives raw pointers to them (ctypes) and must match
 * engine/voicestate.py's formulas EXACTLY — tests/test_hostcore.py asserts
 * bit-equality of every produced array against the numpy path.
 *
 * Layout contract (see libzl_tpu/engine/hostcore.py):
 *   - all [V] state arrays passed individually (int64/int32/float32/f64/bool)
 *   - program outputs are the packed int32/float32 matrices of
 *     ops/voice.pack_program, written directly (no repacking on the host).
 */

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kSegments = 4;           // MAX_SEGMENTS_PER_BLOCK
constexpr int64_t kBig = 1LL << 30;

// envelope stages (ops/adsr.py)
constexpr int kIdle = 0, kAttack = 1, kDecay = 2, kSustain = 3, kRelease = 4;
constexpr int kRelModeLinear = 0, kRelModeExp = 1;

// packed program column layout (ops/voice.pack_program)
// ints: active, base, len_minus1, rate_int, start_frame, stop_frame, lane,
//       stage0, release_frame, rel_mode, seg_start[4], seg_pos_int[4],
//       loop_period, bq_reset[W]
//       -> 19 + W columns (W = Params.n_bq_extra, static per engine)
// floats: rate_frac, gain, clip_volume, pan, env0, a_rate, d_rate, sustain,
//         rel_rate, inv_rel, rel_log2, seg_pos_frac[4]        -> 15 columns
constexpr int kNIBase = 19;
constexpr int kNF = 15;

struct State {
  // in/out state (mirrors VoicePool's arrays)
  uint8_t *active;
  int64_t *clip_id;
  int64_t *pos_int;
  float *pos_frac;
  int32_t *rate_int;
  float *rate_frac;
  int64_t *istart;
  int64_t *stop;
  uint8_t *looping;
  uint8_t *beat_quantized;
  int64_t *loop_len_ticks;
  int64_t *next_loop_tick;
  float *gain;
  float *clip_volume;
  float *pan;
  int32_t *lane;
  int32_t *stage;
  float *env;
  float *a_rate;
  float *d_rate;
  float *sustain;
  float *rel_rate;
  float *inv_rel;
  float *rel_log2;
  int32_t *rel_mode;
  float *release_sec;
  int64_t *pending_start;
  int64_t *pending_release;
  int64_t *position_id;
  int32_t *base;
  int32_t *length;
  double *source_rate;
  uint8_t *lane_enabled;  // [num_lanes]
};

struct Params {
  int64_t num_voices;
  int64_t block_frames;
  double block_start_sample;
  double tick_anchor_sample;
  int64_t tick_anchor;
  double samples_per_tick;
  // beat-quantized reset columns past the segment horizon
  // (constants.bq_extra_resets; 0 at the live geometry)
  int64_t n_bq_extra;
};

// juce-compatible ADS envelope value at voice-local frame k (f32 arithmetic,
// matching ops/adsr.ads_env_at exactly)
inline float ads_env_at(int stage0, float env0, float a_rate, float d_rate,
                        float sustain, int64_t k) {
  bool in_attack = stage0 == kAttack;
  int64_t ka = 0;
  if (in_attack && a_rate > 0.0f) {
    ka = (int64_t)std::max(std::ceil((1.0f - env0) / a_rate), 0.0f);
  }
  float e_d = in_attack ? 1.0f : env0;
  bool has_decay = (in_attack && d_rate > 0.0f) || stage0 == kDecay;
  int64_t kd = 0;
  if (has_decay && d_rate > 0.0f) {
    kd = (int64_t)std::max(std::ceil((e_d - sustain) / d_rate), 0.0f);
  }
  float e_s = has_decay ? sustain : e_d;
  if (k < ka) {
    return std::min(env0 + (float)(k + 1) * a_rate, 1.0f);
  }
  if (k < ka + kd) {
    return std::max(e_d - (float)(k - ka + 1) * d_rate, sustain);
  }
  return e_s;
}

// full envelope value at voice-local frame k with a release trigger at rf
// (matching ops/adsr.envelope_values)
inline float envelope_at(int stage0, float env0, float a_rate, float d_rate,
                         float sustain, float rel_rate, float inv_rel,
                         float rel_log2, int64_t rf, int rel_mode, int64_t k) {
  if (stage0 == kIdle) return 0.0f;
  if (stage0 == kRelease) {
    float sf = (float)std::max(k + 1, (int64_t)0);
    if (rel_mode == kRelModeExp) return env0 * std::exp2(sf * rel_log2);
    return std::max(env0 - sf * rel_rate, 0.0f);
  }
  if (k < rf) {
    return ads_env_at(stage0, env0, a_rate, d_rate, sustain, k);
  }
  float e_r = rf > 0
                  ? ads_env_at(stage0, env0, a_rate, d_rate, sustain,
                               std::max(rf - 1, (int64_t)0))
                  : env0;
  if (inv_rel <= 0.0f) return 0.0f;
  float sf = (float)std::max(k - rf + 1, (int64_t)0);
  if (rel_mode == kRelModeExp) return e_r * std::exp2(sf * rel_log2);
  float new_rate = e_r * inv_rel;
  return std::max(e_r - sf * new_rate, 0.0f);
}

// One voice's build_program + advance for one block: writes the packed
// program row (pi [kNIBase+W] int32, pf [kNF] float32), advances the voice's
// state arrays past the block exactly as engine/voicestate.VoicePool's
// build_program + advance pair does, and returns whether the voice died
// this block (the CALLER kills — it may need clip_id/position_id first).
static inline bool update_voice(const Params *p, State *s, int64_t v,
                                int32_t *pi, float *pf) {
  const int64_t B = p->block_frames;
  const int W = (int)p->n_bq_extra;
  const int kNI = kNIBase + W;
  {
    std::memset(pi, 0, sizeof(int32_t) * kNI);
    std::memset(pf, 0, sizeof(float) * kNF);
    // inactive program row defaults
    pi[2] = 1;                       // len_minus1
    pi[5] = (int32_t)B;              // stop_frame
    pi[8] = (int32_t)B;              // release_frame
    for (int j = 0; j < kSegments; ++j) pi[10 + j] = (int32_t)B;
    for (int j = 0; j < W; ++j) pi[kNIBase + j] = (int32_t)B;

    bool act = s->active[v] && s->lane_enabled[s->lane[v]];
    if (!act) {
      // pending events are consumed per block regardless (the numpy
      // mirror clears them globally in advance())
      s->pending_start[v] = -1;
      s->pending_release[v] = kBig;
      return false;
    }

    const double posf = (double)s->pos_int[v] + (double)s->pos_frac[v];
    const double rate = (double)s->rate_int[v] + (double)s->rate_frac[v];
    const double rate_safe = rate > 0.0 ? rate : 1.0;
    const int64_t start_f =
        s->pending_start[v] >= 0 ? s->pending_start[v] : 0;

    // --- segments / wrap schedule (voicestate.build_program) ---
    int64_t seg_start[kSegments], seg_pos_int[kSegments];
    float seg_pos_frac[kSegments];
    for (int j = 0; j < kSegments; ++j) {
      seg_start[j] = B;
      seg_pos_int[j] = 0;
      seg_pos_frac[j] = 0.0f;
    }
    seg_start[0] = start_f;
    seg_pos_int[0] = s->pos_int[v];
    seg_pos_frac[0] = s->pos_frac[v];

    const int64_t n1 = std::max(
        (int64_t)std::ceil(((double)s->stop[v] - posf) / rate_safe),
        (int64_t)1);
    const int64_t pos_period = std::max(
        (int64_t)std::ceil((double)(s->stop[v] - s->istart[v]) / rate_safe),
        (int64_t)1);
    const double next_loop_sample =
        p->tick_anchor_sample +
        (double)(s->next_loop_tick[v] - p->tick_anchor) * p->samples_per_tick;
    const double bq_diff = next_loop_sample - p->block_start_sample;
    const double bq_period =
        std::max((double)s->loop_len_ticks[v] * p->samples_per_tick, 1.0);

    const bool is_bq = s->looping[v] && s->beat_quantized[v];
    const bool is_pos = s->looping[v] && !s->beat_quantized[v];
    // exact wrap count, NOT capped at the segment horizon (mirrors
    // voicestate.build_program): #{m >= 0 : bq_diff + m*period <= B-1}
    int64_t bq_wraps = 0;
    if (is_bq && bq_diff <= (double)(B - 1)) {
      bq_wraps = (int64_t)std::floor(
                     ((double)(B - 1) - bq_diff) / bq_period) + 1;
    }
    // last expressed in-block bq reset (segments + extras), -1 if none —
    // the advance tail rebases the end-of-block position from it
    int64_t bq_last_reset = -1;
    bool prev_bq_hit = is_bq;  // wrap chain: extras need every prior hit
    for (int sI = 1; sI < kSegments; ++sI) {
      int64_t r;
      if (is_bq) {
        int64_t k0 = (int64_t)std::max(
            std::ceil(bq_diff + (double)(sI - 1) * bq_period), 0.0);
        r = k0 + 1;
      } else if (is_pos) {
        r = start_f + n1 + (int64_t)(sI - 1) * pos_period;
      } else {
        continue;
      }
      bool hit = r < B && r >= start_f;
      if (hit) {
        seg_start[sI] = r;
        seg_pos_int[sI] = s->istart[v];
        seg_pos_frac[sI] = 0.0f;
      }
      if (is_bq) {
        if (hit) bq_last_reset = r;
        prev_bq_hit = prev_bq_hit && hit;
      }
    }
    // beat-quantized resets past the segment horizon: explicit integer
    // reset-frame columns (mirrors voicestate.build_program; the device
    // applies them as `k >= r` rebases — exact unlimited wraps where the
    // reference wraps per sample, lib/SamplerSynthVoice.cpp:225-242)
    for (int e = 0; e < W; ++e) {
      if (!is_bq) break;
      int64_t k0 = (int64_t)std::max(
          std::ceil(bq_diff + (double)(kSegments + e - 1) * bq_period), 0.0);
      int64_t r = k0 + 1;
      bool hit = prev_bq_hit && r < B && r >= start_f;
      if (hit) {
        pi[kNIBase + e] = (int32_t)r;
        bq_last_reset = r;
      }
      prev_bq_hit = prev_bq_hit && hit;
    }
    // boundary wrap: only the LAST counted wrap can land exactly at frame B
    bool bq_boundary = false;
    if (is_bq && bq_wraps >= 1) {
      double r_w_last =
          std::ceil(bq_diff + (double)(bq_wraps - 1) * bq_period) + 1.0;
      bq_boundary = r_w_last == (double)B;
    }

    // --- stop frame (hard stop / ADSR death) ---
    int64_t stop_frame = B;
    if (!s->looping[v]) {
      int64_t end_frame =
          start_f +
          (int64_t)std::ceil(((double)s->stop[v] - posf) / rate_safe);
      stop_frame = std::min(std::max(end_frame, (int64_t)0), B);
    }

    // --- release triggers ---
    int64_t release_frame = s->pending_release[v];
    bool release_is_auto = false;
    const double thr =
        (double)s->stop[v] - (double)s->release_sec[v] * s->source_rate[v];
    int64_t k_ar =
        start_f + (int64_t)std::ceil((thr - posf) / rate_safe) + 1;
    k_ar = std::max(k_ar, (int64_t)0);
    if (!s->looping[v] && s->stage[v] != kRelease && s->stage[v] != kIdle &&
        k_ar < std::min(release_frame, B)) {
      release_is_auto = true;
      release_frame = k_ar;
    }
    if (s->stage[v] == kRelease && s->rel_mode[v] == kRelModeLinear &&
        s->rel_rate[v] > 0.0f) {
      int64_t death = (int64_t)std::ceil((double)s->env[v] /
                                         (double)s->rel_rate[v]);
      stop_frame = std::min(
          stop_frame,
          std::min(std::max(start_f + death, (int64_t)0), B));
    }
    int64_t release_local =
        std::min(std::max(release_frame - start_f, (int64_t)0), kBig);
    int32_t rel_mode_prog =
        release_is_auto ? kRelModeExp : s->rel_mode[v];

    // --- fill the packed program row ---
    pi[0] = 1;                                  // active
    pi[1] = s->base[v];
    pi[2] = std::max(s->length[v] - 1, (int32_t)1);
    pi[3] = s->rate_int[v];
    pi[4] = (int32_t)start_f;
    pi[5] = (int32_t)stop_frame;
    pi[6] = s->lane[v];
    pi[7] = s->stage[v];
    pi[8] = (int32_t)release_local;
    pi[9] = rel_mode_prog;
    for (int j = 0; j < kSegments; ++j) {
      pi[10 + j] = (int32_t)std::min(seg_start[j], B);
      pi[14 + j] = (int32_t)seg_pos_int[j];
    }
    // loop-containment column (ops/voice.py positions_block): positional
    // loops needing more wraps than the segment schedule can express wrap
    // exactly via j mod loop_period inside the wrap segments
    pi[18] = is_pos ? (int32_t)pos_period : 0;
    pf[0] = s->rate_frac[v];
    pf[1] = s->gain[v];
    pf[2] = s->clip_volume[v];
    pf[3] = s->pan[v];
    pf[4] = s->env[v];
    pf[5] = s->a_rate[v];
    pf[6] = s->d_rate[v];
    pf[7] = s->sustain[v];
    pf[8] = s->rel_rate[v];
    pf[9] = s->inv_rel[v];
    pf[10] = s->rel_log2[v];
    for (int j = 0; j < kSegments; ++j) pf[11 + j] = seg_pos_frac[j];

    // ================= advance (voicestate.VoicePool.advance) =============
    // position at frame B via the device's own segment formula
    int last = 0;
    for (int j = kSegments - 1; j >= 0; --j) {
      if (seg_start[j] < B) {
        last = j;
        break;
      }
    }
    int64_t jframes = std::max(B - seg_start[last], (int64_t)0);
    float frac_full =
        seg_pos_frac[last] + (float)jframes * s->rate_frac[v];
    float carry = std::floor(frac_full);
    int64_t new_pos_int =
        seg_pos_int[last] + jframes * (int64_t)s->rate_int[v] +
        (int64_t)carry;
    float new_pos_frac = frac_full - carry;
    // positional resets past frame B: the extrapolation can cross `stop`
    // one or MORE times; each reset discards fractional overshoot and
    // restarts at the integer loop start, so the state at frame B is
    // istart + ((j - n1) mod period) * rate exactly (mirrors
    // voicestate.advance)
    const int64_t n1_local = std::max(
        (int64_t)std::ceil(((double)s->stop[v] -
                            ((double)seg_pos_int[last] +
                             (double)seg_pos_frac[last])) /
                           rate_safe),
        (int64_t)1);
    if (is_pos && jframes >= n1_local) {
      int64_t j2 = (jframes - n1_local) % pos_period;
      float frac2 = (float)j2 * s->rate_frac[v];
      float carry2 = std::floor(frac2);
      new_pos_int =
          s->istart[v] + j2 * (int64_t)s->rate_int[v] + (int64_t)carry2;
      new_pos_frac = frac2 - carry2;
    }
    // beat-quantized: rebase from the last EXPRESSED in-block reset —
    // exactly what the device applied (bit-identical to the wrap-segment
    // extrapolation for wraps within the horizon; contains the position
    // past it). Boundary wrap (reset at frame B) snaps to the loop start.
    if (bq_last_reset >= 0) {
      int64_t jb = std::max(B - bq_last_reset, (int64_t)0);
      float fracb = (float)jb * s->rate_frac[v];
      float carryb = std::floor(fracb);
      new_pos_int =
          s->istart[v] + jb * (int64_t)s->rate_int[v] + (int64_t)carryb;
      new_pos_frac = fracb - carryb;
    }
    if (bq_boundary) {
      new_pos_int = s->istart[v];
      new_pos_frac = 0.0f;
    }
    s->pos_int[v] = new_pos_int;
    s->pos_frac[v] = new_pos_frac;

    // envelope at the last rendered frame (voice-local)
    int64_t n_frames = B - start_f;
    float env_last = envelope_at(
        s->stage[v], s->env[v], s->a_rate[v], s->d_rate[v], s->sustain[v],
        s->rel_rate[v], s->inv_rel[v], s->rel_log2[v], release_local,
        rel_mode_prog, std::max(n_frames - 1, (int64_t)0));
    bool released = release_local < n_frames;
    if (released && rel_mode_prog == kRelModeLinear) {
      float e_r = release_local > 0
                      ? ads_env_at(s->stage[v], s->env[v], s->a_rate[v],
                                   s->d_rate[v], s->sustain[v],
                                   release_local - 1)
                      : s->env[v];
      s->rel_rate[v] = e_r * s->inv_rel[v];
    }
    if (released) {
      s->rel_mode[v] = rel_mode_prog;
      s->stage[v] = kRelease;
    } else if (s->stage[v] == kAttack || s->stage[v] == kDecay) {
      // stage after n_frames with no release (closed form)
      int64_t ka = 0, kd = 0;
      bool in_attack = s->stage[v] == kAttack;
      if (in_attack && s->a_rate[v] > 0.0f) {
        ka = (int64_t)std::max(
            std::ceil((1.0f - s->env[v]) / s->a_rate[v]), 0.0f);
      }
      float e_d = in_attack ? 1.0f : s->env[v];
      bool has_decay =
          (in_attack && s->d_rate[v] > 0.0f) || s->stage[v] == kDecay;
      if (has_decay && s->d_rate[v] > 0.0f) {
        kd = (int64_t)std::max(
            std::ceil((e_d - s->sustain[v]) / s->d_rate[v]), 0.0f);
      }
      if (in_attack) {
        if (n_frames > ka) {
          s->stage[v] = (has_decay && n_frames <= ka + kd) ? kDecay : kSustain;
        }
      } else {  // decay
        if (n_frames > kd) s->stage[v] = kSustain;
      }
    }
    s->env[v] = env_last;

    // beat-quantized loop tick bookkeeping
    if (s->beat_quantized[v]) {
      s->next_loop_tick[v] += bq_wraps * s->loop_len_ticks[v];
    }

    // deaths (mirror voicestate.advance exactly): hard stop reached,
    // release completed, or an unreleased voice already idle
    bool dead = (stop_frame < B) ||
                (s->stage[v] == kRelease && s->env[v] <= 0.0f) ||
                (!released && s->stage[v] == kIdle);
    s->pending_start[v] = -1;
    s->pending_release[v] = kBig;
    return dead;
  }
}

// VoicePool.kill(v) (engine/voicestate.py)
static inline void kill_voice(State *s, int64_t v) {
  s->active[v] = 0;
  s->position_id[v] = -1;
  s->clip_id[v] = -1;
  s->stage[v] = kIdle;
  s->env[v] = 0.0f;
}

// Per-slice snapshot buffers for the horizon sim: each pointer is an [H, V]
// array (row-major); row h receives the state AFTER slice h's advance+kills.
// Mirrors VoicePool._ADVANCE_FIELDS / save_state() exactly.
struct Snaps {
  uint8_t *active;
  int64_t *clip_id;
  int64_t *position_id;
  int64_t *pos_int;
  float *pos_frac;
  int32_t *stage;
  float *env;
  float *rel_rate;
  int32_t *rel_mode;
  int64_t *next_loop_tick;
  int64_t *pending_start;
  int64_t *pending_release;
};

static inline void snapshot_row(const State *s, const Snaps *o, int64_t h,
                                int64_t V) {
  std::memcpy(o->active + h * V, s->active, (size_t)V);
  std::memcpy(o->clip_id + h * V, s->clip_id, (size_t)V * 8);
  std::memcpy(o->position_id + h * V, s->position_id, (size_t)V * 8);
  std::memcpy(o->pos_int + h * V, s->pos_int, (size_t)V * 8);
  std::memcpy(o->pos_frac + h * V, s->pos_frac, (size_t)V * 4);
  std::memcpy(o->stage + h * V, s->stage, (size_t)V * 4);
  std::memcpy(o->env + h * V, s->env, (size_t)V * 4);
  std::memcpy(o->rel_rate + h * V, s->rel_rate, (size_t)V * 4);
  std::memcpy(o->rel_mode + h * V, s->rel_mode, (size_t)V * 4);
  std::memcpy(o->next_loop_tick + h * V, s->next_loop_tick, (size_t)V * 8);
  std::memcpy(o->pending_start + h * V, s->pending_start, (size_t)V * 8);
  std::memcpy(o->pending_release + h * V, s->pending_release,
              (size_t)V * 8);
}

// compact-horizon dynamics constants (ops/voice.py pack_horizon_dynamics)
constexpr int32_t kRf16 = 0xFFFF;        // 16-bit release field / sentinel
constexpr int32_t kReleaseNone = 1 << 30;  // RELEASE_NONE
// packed column indices (ops/voice.py PI_*/PF_*; static layout, asserted
// against the python side at import by engine/hostcore.py)
constexpr int kPiActive = 0, kPiStart = 4, kPiStop = 5, kPiStage0 = 7,
              kPiRelease = 8, kPiRelMode = 9, kPiSegStart = 10,
              kPiSegPos = 14, kPiBq = kNIBase;
constexpr int kPfEnv0 = 4, kPfRelRate = 8, kPfSegFrac = 11;

}  // namespace

extern "C" {

/*
 * One-pass build_program + advance for all voices.
 *
 * Writes the packed program matrices (prog_i [V, 19+W] int32,
 * prog_f [V, 15] float32) for the device dispatch, then advances the state
 * arrays past the block exactly as engine/voicestate.VoicePool.advance()
 * does. `died_out` receives indices of voices that stopped (count
 * returned); the Python wrapper reads (clip_id, position_id) for the
 * positions-model cleanup and then performs the full kill().
 */
int64_t zl_voice_update(const Params *p, State *s, int32_t *prog_i,
                        float *prog_f, int64_t *died_out) {
  const int64_t V = p->num_voices;
  const int kNI = kNIBase + (int)p->n_bq_extra;
  int64_t died_count = 0;
  for (int64_t v = 0; v < V; ++v) {
    if (update_voice(p, s, v, prog_i + v * kNI, prog_f + v * kNF)) {
      died_out[died_count++] = v;
    }
  }
  return died_count;
}

/*
 * The whole lookahead-horizon host sim in ONE call, instead of H
 * Python->ctypes per-block sims plus numpy dynamics packing.
 *
 * Simulates H consecutive blocks from the current pool state — exactly the
 * per-block update_voice chain, so device programs are bit-identical to
 * per-block dispatch — writing:
 *   - prog_i0/prog_f0: slice 0's full packed program [V, 19+W]/[V, 15]
 *   - dyn: the compact dynamics matrix [V, 1 + (H-1)*D] of
 *     ops/voice.pack_horizon_dynamics (col 0 = istart; per tail slice:
 *     pos anchor, pos_frac/env0/rel_rate bits, 16-bit wrap/stop pairs,
 *     flags, 16-bit bq-reset pairs) — bit-identical to the numpy packer
 *   - snaps: per-slice post-advance state snapshots ([H, V] per field)
 *   - died_out [H*V*3]: (voice, clip_id, position_id) triples per slice,
 *     counts in died_counts [H]; kills applied natively before the next
 *     slice (ids recorded pre-kill)
 *
 * Returns 0, or 1 when a tail slice exceeds the compact encoding (release
 * frame neither in-block nor "none", a pending start past slice 0, a
 * negative position anchor, or a 16-bit field out of range) — the caller
 * falls back to per-block dispatch and restores its pre-sim snapshot
 * (pool state is partially advanced on failure, same contract as the
 * numpy packer returning None).
 */
int64_t zl_horizon_update(const Params *p, State *s, int64_t H,
                          int32_t *prog_i0, float *prog_f0, int32_t *dyn,
                          const Snaps *snaps, int64_t *died_out,
                          int64_t *died_counts) {
  const int64_t V = p->num_voices;
  const int W = (int)p->n_bq_extra;
  const int kNI = kNIBase + W;
  constexpr int kNpack = (kSegments + 1) / 2;
  const int D = 4 + kNpack + 1 + (W + 1) / 2;
  const int64_t stride = 1 + (H - 1) * (int64_t)D;
  // tail-slice scratch row (slice 0 writes straight into prog_*0)
  int32_t tpi[64];
  float tpf[kNF];
  if (kNI > 64) return 1;  // absurd bq-extra geometry: per-block fallback

  for (int64_t h = 0; h < H; ++h) {
    Params ph = *p;
    ph.block_start_sample =
        p->block_start_sample + (double)(h * p->block_frames);
    int64_t *died_row = died_out + h * V * 3;
    int64_t n_died = 0;
    for (int64_t v = 0; v < V; ++v) {
      int32_t *pi;
      float *pf;
      if (h == 0) {
        pi = prog_i0 + v * kNI;
        pf = prog_f0 + v * kNF;
      } else {
        pi = tpi;
        pf = tpf;
      }
      bool died = update_voice(&ph, s, v, pi, pf);
      if (h == 0) {
        dyn[v * stride] = (int32_t)s->istart[v];
      } else {
        // encodability checks — EXACTLY pack_horizon_dynamics's
        const int32_t rf = pi[kPiRelease];
        if (rf >= kRf16 && rf != kReleaseNone) return 1;
        if (pi[kPiStart] != 0) return 1;
        if (pi[kPiSegPos] < 0) return 1;
        for (int j = 1; j < kSegments; ++j) {
          const int32_t x = pi[kPiSegStart + j];
          if (x < 0 || x > kRf16) return 1;
        }
        if (pi[kPiStop] < 0 || pi[kPiStop] > kRf16) return 1;
        for (int j = 0; j < W; ++j) {
          const int32_t x = pi[kPiBq + j];
          if (x < 0 || x > kRf16) return 1;
        }
        int32_t *row = dyn + v * stride + 1 + (h - 1) * D;
        row[0] = pi[kPiSegPos];
        std::memcpy(row + 1, pf + kPfSegFrac, 4);
        std::memcpy(row + 2, pf + kPfEnv0, 4);
        std::memcpy(row + 3, pf + kPfRelRate, 4);
        // 16-bit pairs of [wrap_1..wrap_{S-1}, stop]
        int32_t fields[kSegments];
        for (int j = 1; j < kSegments; ++j) fields[j - 1] = pi[kPiSegStart + j];
        fields[kSegments - 1] = pi[kPiStop];
        for (int c = 0; c < kNpack; ++c) {
          const int32_t lo = fields[2 * c];
          const int32_t hi = (2 * c + 1 < kSegments) ? fields[2 * c + 1] : 0;
          row[4 + c] = lo | (hi << 16);
        }
        row[4 + kNpack] = std::min(rf, kRf16) | (pi[kPiActive] << 16) |
                          (pi[kPiStage0] << 17) | (pi[kPiRelMode] << 20);
        for (int c = 0; c < (W + 1) / 2; ++c) {
          const int32_t lo = pi[kPiBq + 2 * c];
          const int32_t hi = (2 * c + 1 < W) ? pi[kPiBq + 2 * c + 1] : 0;
          row[5 + kNpack + c] = lo | (hi << 16);
        }
      }
      if (died) {
        died_row[n_died * 3 + 0] = v;
        died_row[n_died * 3 + 1] = s->clip_id[v];
        died_row[n_died * 3 + 2] = s->position_id[v];
        ++n_died;
      }
    }
    died_counts[h] = n_died;
    for (int64_t i = 0; i < n_died; ++i) kill_voice(s, died_row[i * 3]);
    snapshot_row(s, snaps, h, V);
  }
  return 0;
}

int zl_hostcore_abi_version(void) { return 6; }

}  // extern "C"
