/*
 * libzl.h — C ABI of the JAX libzl engine.
 *
 * Symbol-compatible with the reference engine's public header
 * (reference lib/libzl.h:18-179): the same extern "C" function names and
 * signatures, so existing ctypes clients (e.g. the reference's
 * test/playtest.py) run unmodified against this library. Object pointers
 * are opaque handles; internally they carry the engine's integer clip ids.
 */

#pragma once

#include <stdbool.h>

#ifdef __cplusplus
class ClipAudioSource;
extern "C" {
#else
typedef struct ClipAudioSource ClipAudioSource;
#endif

/* ---- ClipAudioSource ---- */
ClipAudioSource *ClipAudioSource_byID(int id);
ClipAudioSource *ClipAudioSource_new(const char *filepath, bool muted);
void ClipAudioSource_setProgressCallback(ClipAudioSource *c,
                                         void (*functionPtr)(float));
void ClipAudioSource_connectProgress(ClipAudioSource *c, void *obj);
void ClipAudioSource_play(ClipAudioSource *c, bool loop);
void ClipAudioSource_stop(ClipAudioSource *c);
void ClipAudioSource_playOnChannel(ClipAudioSource *c, bool loop,
                                   int midiChannel);
void ClipAudioSource_stopOnChannel(ClipAudioSource *c, int midiChannel);
float ClipAudioSource_getDuration(ClipAudioSource *c);
const char *ClipAudioSource_getFileName(ClipAudioSource *c);
void ClipAudioSource_setStartPosition(ClipAudioSource *c,
                                      float startPositionInSeconds);
void ClipAudioSource_setLength(ClipAudioSource *c, float beat, int bpm);
void ClipAudioSource_setPan(ClipAudioSource *c, float pan);
void ClipAudioSource_setSpeedRatio(ClipAudioSource *c, float speedRatio);
void ClipAudioSource_setPitch(ClipAudioSource *c, float pitchChange);
void ClipAudioSource_setGain(ClipAudioSource *c, float db);
void ClipAudioSource_setVolume(ClipAudioSource *c, float vol);
void ClipAudioSource_setAudioLevelChangedCallback(ClipAudioSource *c,
                                                  void (*functionPtr)(float));
void ClipAudioSource_setSlices(ClipAudioSource *c, int slices);
/* extension beyond the reference header: loop-seam crossfade baked into the
 * playback render (0 = off, the reference behavior of a hard loop reset) */
void ClipAudioSource_setLoopCrossfade(ClipAudioSource *c, float seconds);
int ClipAudioSource_keyZoneStart(ClipAudioSource *c);
void ClipAudioSource_setKeyZoneStart(ClipAudioSource *c, int keyZoneStart);
int ClipAudioSource_keyZoneEnd(ClipAudioSource *c);
void ClipAudioSource_setKeyZoneEnd(ClipAudioSource *c, int keyZoneEnd);
int ClipAudioSource_rootNote(ClipAudioSource *c);
void ClipAudioSource_setRootNote(ClipAudioSource *c, int rootNote);
void ClipAudioSource_destroy(ClipAudioSource *c);
int ClipAudioSource_id(ClipAudioSource *c);

float ClipAudioSource_adsrAttack(ClipAudioSource *c);
void ClipAudioSource_setADSRAttack(ClipAudioSource *c, float newValue);
float ClipAudioSource_adsrDecay(ClipAudioSource *c);
void ClipAudioSource_setADSRDecay(ClipAudioSource *c, float newValue);
float ClipAudioSource_adsrSustain(ClipAudioSource *c);
void ClipAudioSource_setADSRSustain(ClipAudioSource *c, float newValue);
float ClipAudioSource_adsrRelease(ClipAudioSource *c);
void ClipAudioSource_setADSRRelease(ClipAudioSource *c, float newValue);

/* ---- SyncTimer ---- */
void *SyncTimer_instance(void);
void SyncTimer_startTimer(int interval);
void SyncTimer_setBpm(unsigned int bpm);
int SyncTimer_getMultiplier(void);
void SyncTimer_stopTimer(void);
void SyncTimer_registerTimerCallback(void (*functionPtr)(int));
void SyncTimer_deregisterTimerCallback(void (*functionPtr)(int));
void SyncTimer_queueClipToStart(ClipAudioSource *clip);
void SyncTimer_queueClipToStartOnChannel(ClipAudioSource *clip,
                                         int midiChannel);
void SyncTimer_queueClipToStop(ClipAudioSource *clip);
void SyncTimer_queueClipToStopOnChannel(ClipAudioSource *clip,
                                        int midiChannel);

/* ---- lifecycle / misc ---- */
void initJuce(void);
void shutdownJuce(void);
void reloadZynthianConfiguration(void);
void registerGraphicTypes(void);
void stopClips(int size, ClipAudioSource **clips);
float dBFromVolume(float vol);

/* ---- AudioLevels ---- */
bool AudioLevels_isRecording(void);
void AudioLevels_setRecordGlobalPlayback(bool shouldRecord);
void AudioLevels_setGlobalPlaybackFilenamePrefix(const char *fileNamePrefix);
void AudioLevels_startRecording(void);
void AudioLevels_stopRecording(void);
void AudioLevels_setRecordPortsFilenamePrefix(const char *fileNamePrefix);
void AudioLevels_addRecordPort(const char *portName, int channel);
void AudioLevels_removeRecordPort(const char *portName, int channel);
void AudioLevels_clearRecordPorts(void);
void AudioLevels_setShouldRecordPorts(bool shouldRecord);

/* ---- JackPassthrough (channel -1 = GlobalPlayback, 0..9 = channels) ---- */
void JackPassthrough_setPanAmount(int channel, float amount);
float JackPassthrough_getPanAmount(int channel);
float JackPassthrough_getWetFx1Amount(int channel);
void JackPassthrough_setWetFx1Amount(int channel, float amount);
float JackPassthrough_getWetFx2Amount(int channel);
void JackPassthrough_setWetFx2Amount(int channel, float amount);
float JackPassthrough_getDryAmount(int channel);
void JackPassthrough_setDryAmount(int channel, float amount);
float JackPassthrough_getMuted(int channel);
void JackPassthrough_setMuted(int channel, bool muted);

#ifdef __cplusplus
}
#endif
