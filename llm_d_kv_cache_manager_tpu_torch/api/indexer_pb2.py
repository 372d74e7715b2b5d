# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: llm_d_kv_cache_manager_tpu/api/indexer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n,llm_d_kv_cache_manager_tpu/api/indexer.proto\x12\x0ckvtpu.api.v1\"t\n\x13GetPodScoresRequest\x12\x0e\n\x06prompt\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\x12\x17\n\x0fpod_identifiers\x18\x03 \x03(\t\x12\x14\n\x07lora_id\x18\x04 \x01(\x03H\x00\x88\x01\x01\x42\n\n\x08_lora_id\"1\n\x08PodScore\x12\x16\n\x0epod_identifier\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x01\">\n\x14GetPodScoresResponse\x12&\n\x06scores\x18\x01 \x03(\x0b\x32\x16.kvtpu.api.v1.PodScore2g\n\x0eIndexerService\x12U\n\x0cGetPodScores\x12!.kvtpu.api.v1.GetPodScoresRequest\x1a\".kvtpu.api.v1.GetPodScoresResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'llm_d_kv_cache_manager_tpu_torch.api.indexer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GETPODSCORESREQUEST._serialized_start=62
  _GETPODSCORESREQUEST._serialized_end=178
  _PODSCORE._serialized_start=180
  _PODSCORE._serialized_end=229
  _GETPODSCORESRESPONSE._serialized_start=231
  _GETPODSCORESRESPONSE._serialized_end=293
  _INDEXERSERVICE._serialized_start=295
  _INDEXERSERVICE._serialized_end=398
# @@protoc_insertion_point(module_scope)
