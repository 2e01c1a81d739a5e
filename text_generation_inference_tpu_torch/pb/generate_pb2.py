# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: generate.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0egenerate.proto\x12\x0bgenerate.v1\"\x0f\n\rHealthRequest\"\x10\n\x0eHealthResponse\"\x19\n\x17ServiceDiscoveryRequest\"(\n\x18ServiceDiscoveryResponse\x12\x0c\n\x04urls\x18\x01 \x03(\t\"\x13\n\x11\x43learCacheRequest\"\x14\n\x12\x43learCacheResponse\"\x12\n\x10ModelInfoRequest\"\xca\x01\n\x12MemoryScalingModel\x12\x1c\n\x14prefill_linear_coef0\x18\x01 \x01(\x02\x12\x1f\n\x17prefill_quadratic_coef0\x18\x02 \x01(\x02\x12\x1f\n\x17prefill_quadratic_coef1\x18\x03 \x01(\x02\x12\x1e\n\x16nexttoken_linear_coef0\x18\x04 \x01(\x02\x12\x1e\n\x16nexttoken_linear_coef1\x18\x05 \x01(\x02\x12\x14\n\x0cweight_limit\x18\x06 \x01(\x04\"\xe6\x01\n\x11ModelInfoResponse\x12<\n\nmodel_type\x18\x01 \x01(\x0e\x32(.generate.v1.ModelInfoResponse.ModelType\x12\x11\n\teos_token\x18\x02 \x01(\r\x12\x15\n\rbatch_padding\x18\x03 \x01(\x08\x12=\n\x14memory_scaling_model\x18\x04 \x01(\x0b\x32\x1f.generate.v1.MemoryScalingModel\"*\n\tModelType\x12\r\n\tCAUSAL_LM\x10\x00\x12\x0e\n\nSEQ2SEQ_LM\x10\x01\"\xf1\x02\n\x1aNextTokenChooserParameters\x12\x13\n\x0btemperature\x18\x01 \x01(\x02\x12\r\n\x05top_k\x18\x02 \x01(\r\x12\r\n\x05top_p\x18\x03 \x01(\x02\x12\x11\n\ttypical_p\x18\x04 \x01(\x02\x12\x16\n\x0emin_new_tokens\x18\x64 \x01(\r\x12\x11\n\x04seed\x18\x65 \x01(\x04H\x00\x88\x01\x01\x12\x1f\n\x12repetition_penalty\x18\x66 \x01(\x02H\x01\x88\x01\x01\x12R\n\x0elength_penalty\x18g \x01(\x0b\x32\x35.generate.v1.NextTokenChooserParameters.LengthPenaltyH\x02\x88\x01\x01\x1a:\n\rLengthPenalty\x12\x13\n\x0bstart_index\x18\x01 \x01(\r\x12\x14\n\x0c\x64\x65\x63\x61y_factor\x18\x02 \x01(\x02\x42\x07\n\x05_seedB\x15\n\x13_repetition_penaltyB\x11\n\x0f_length_penalty\"[\n\x10RequestedDetails\x12\x12\n\ninput_toks\x18\x01 \x01(\x08\x12\x10\n\x08logprobs\x18\x02 \x01(\x08\x12\r\n\x05ranks\x18\x03 \x01(\x08\x12\x12\n\ntop_n_toks\x18\x04 \x01(\r\"\x81\x02\n\x07Request\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x11\n\tprefix_id\x18\x02 \x01(\t\x12\x0e\n\x06inputs\x18\x03 \x01(\t\x12\x14\n\x0cinput_length\x18\x04 \x01(\r\x12\x10\n\x08truncate\x18\x05 \x01(\x08\x12\x19\n\x11max_output_length\x18\x06 \x01(\r\x12;\n\nparameters\x18\x07 \x01(\x0b\x32\'.generate.v1.NextTokenChooserParameters\x12\x17\n\x0fstream_response\x18\x64 \x01(\x08\x12.\n\x07\x64\x65tails\x18\x65 \x01(\x0b\x32\x1d.generate.v1.RequestedDetails\"\x1e\n\x0cStopSequence\x12\x0e\n\x06tokens\x18\x01 \x03(\r\"Q\n\x05\x42\x61tch\x12\n\n\x02id\x18\x01 \x01(\x04\x12&\n\x08requests\x18\x02 \x03(\x0b\x32\x14.generate.v1.Request\x12\x14\n\x0ctotal_tokens\x18\x03 \x01(\r\"-\n\x08TopToken\x12\x10\n\x08token_id\x18\x01 \x01(\r\x12\x0f\n\x07logprob\x18\x02 \x01(\x02\"w\n\x05Token\x12\x12\n\nrequest_id\x18\x01 \x01(\x04\x12\x10\n\x08token_id\x18\x02 \x01(\r\x12\x0f\n\x07logprob\x18\x03 \x01(\x02\x12\x0c\n\x04rank\x18\x04 \x01(\r\x12)\n\ntop_tokens\x18\x05 \x03(\x0b\x32\x15.generate.v1.TopToken\"4\n\rGenerateError\x12\x12\n\nrequest_id\x18\x01 \x01(\x04\x12\x0f\n\x07message\x18\x02 \x01(\t\"E\n\x0bInputTokens\x12\x12\n\nrequest_id\x18\x01 \x01(\x04\x12\"\n\x06tokens\x18\x02 \x03(\x0b\x32\x12.generate.v1.Token\"_\n\x0ePrefillRequest\x12!\n\x05\x62\x61tch\x18\x01 \x01(\x0b\x32\x12.generate.v1.Batch\x12*\n\x08to_prune\x18\x02 \x03(\x0b\x32\x18.generate.v1.CachedBatch\"\x92\x01\n\x0eGenerateResult\x12)\n\routput_tokens\x18\x01 \x03(\x0b\x32\x12.generate.v1.Token\x12*\n\x06\x65rrors\x18\x02 \x03(\x0b\x32\x1a.generate.v1.GenerateError\x12\x10\n\x08\x62\x61tch_id\x18\x03 \x01(\x04\x12\x17\n\x0f\x66orward_time_ns\x18\x04 \x01(\x04\"n\n\x0fPrefillResponse\x12+\n\x06result\x18\x01 \x01(\x0b\x32\x1b.generate.v1.GenerateResult\x12.\n\x0cinput_tokens\x18\x02 \x03(\x0b\x32\x18.generate.v1.InputTokens\"\'\n\x0eRequestsStatus\x12\x15\n\rcompleted_ids\x18\x03 \x03(\x04\"\\\n\x0b\x43\x61\x63hedBatch\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\x04\x12\x30\n\x06status\x18\x02 \x01(\x0b\x32\x1b.generate.v1.RequestsStatusH\x00\x88\x01\x01\x42\t\n\x07_status\"=\n\x10NextTokenRequest\x12)\n\x07\x62\x61tches\x18\x01 \x03(\x0b\x32\x18.generate.v1.CachedBatch\"P\n\x11NextTokenResponse\x12\x30\n\x06result\x18\x01 \x01(\x0b\x32\x1b.generate.v1.GenerateResultH\x00\x88\x01\x01\x42\t\n\x07_result\"<\n\x11PruneBatchRequest\x12\'\n\x05\x62\x61tch\x18\x01 \x01(\x0b\x32\x18.generate.v1.CachedBatch\"8\n\x12PruneBatchResponse\x12\x15\n\x08\x62\x61tch_id\x18\x01 \x01(\x04H\x00\x88\x01\x01\x42\x0b\n\t_batch_id\"(\n\x13PrefixLookupRequest\x12\x11\n\tprefix_id\x18\x01 \x01(\t\"-\n\x14PrefixLookupResponse\x12\x15\n\rprefix_length\x18\x01 \x01(\r2\x8e\x05\n\x15TextGenerationService\x12\x61\n\x10ServiceDiscovery\x12$.generate.v1.ServiceDiscoveryRequest\x1a%.generate.v1.ServiceDiscoveryResponse\"\x00\x12M\n\nClearCache\x12\x1e.generate.v1.ClearCacheRequest\x1a\x1f.generate.v1.ClearCacheResponse\x12J\n\tModelInfo\x12\x1d.generate.v1.ModelInfoRequest\x1a\x1e.generate.v1.ModelInfoResponse\x12\x44\n\x07Prefill\x12\x1b.generate.v1.PrefillRequest\x1a\x1c.generate.v1.PrefillResponse\x12J\n\tNextToken\x12\x1d.generate.v1.NextTokenRequest\x1a\x1e.generate.v1.NextTokenResponse\x12M\n\nPruneBatch\x12\x1e.generate.v1.PruneBatchRequest\x1a\x1f.generate.v1.PruneBatchResponse\x12S\n\x0cPrefixLookup\x12 .generate.v1.PrefixLookupRequest\x1a!.generate.v1.PrefixLookupResponse\x12\x41\n\x06Health\x12\x1a.generate.v1.HealthRequest\x1a\x1b.generate.v1.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'generate_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHREQUEST._serialized_start=31
  _HEALTHREQUEST._serialized_end=46
  _HEALTHRESPONSE._serialized_start=48
  _HEALTHRESPONSE._serialized_end=64
  _SERVICEDISCOVERYREQUEST._serialized_start=66
  _SERVICEDISCOVERYREQUEST._serialized_end=91
  _SERVICEDISCOVERYRESPONSE._serialized_start=93
  _SERVICEDISCOVERYRESPONSE._serialized_end=133
  _CLEARCACHEREQUEST._serialized_start=135
  _CLEARCACHEREQUEST._serialized_end=154
  _CLEARCACHERESPONSE._serialized_start=156
  _CLEARCACHERESPONSE._serialized_end=176
  _MODELINFOREQUEST._serialized_start=178
  _MODELINFOREQUEST._serialized_end=196
  _MEMORYSCALINGMODEL._serialized_start=199
  _MEMORYSCALINGMODEL._serialized_end=401
  _MODELINFORESPONSE._serialized_start=404
  _MODELINFORESPONSE._serialized_end=634
  _MODELINFORESPONSE_MODELTYPE._serialized_start=592
  _MODELINFORESPONSE_MODELTYPE._serialized_end=634
  _NEXTTOKENCHOOSERPARAMETERS._serialized_start=637
  _NEXTTOKENCHOOSERPARAMETERS._serialized_end=1006
  _NEXTTOKENCHOOSERPARAMETERS_LENGTHPENALTY._serialized_start=897
  _NEXTTOKENCHOOSERPARAMETERS_LENGTHPENALTY._serialized_end=955
  _REQUESTEDDETAILS._serialized_start=1008
  _REQUESTEDDETAILS._serialized_end=1099
  _REQUEST._serialized_start=1102
  _REQUEST._serialized_end=1359
  _STOPSEQUENCE._serialized_start=1361
  _STOPSEQUENCE._serialized_end=1391
  _BATCH._serialized_start=1393
  _BATCH._serialized_end=1474
  _TOPTOKEN._serialized_start=1476
  _TOPTOKEN._serialized_end=1521
  _TOKEN._serialized_start=1523
  _TOKEN._serialized_end=1642
  _GENERATEERROR._serialized_start=1644
  _GENERATEERROR._serialized_end=1696
  _INPUTTOKENS._serialized_start=1698
  _INPUTTOKENS._serialized_end=1767
  _PREFILLREQUEST._serialized_start=1769
  _PREFILLREQUEST._serialized_end=1864
  _GENERATERESULT._serialized_start=1867
  _GENERATERESULT._serialized_end=2013
  _PREFILLRESPONSE._serialized_start=2015
  _PREFILLRESPONSE._serialized_end=2125
  _REQUESTSSTATUS._serialized_start=2127
  _REQUESTSSTATUS._serialized_end=2166
  _CACHEDBATCH._serialized_start=2168
  _CACHEDBATCH._serialized_end=2260
  _NEXTTOKENREQUEST._serialized_start=2262
  _NEXTTOKENREQUEST._serialized_end=2323
  _NEXTTOKENRESPONSE._serialized_start=2325
  _NEXTTOKENRESPONSE._serialized_end=2405
  _PRUNEBATCHREQUEST._serialized_start=2407
  _PRUNEBATCHREQUEST._serialized_end=2467
  _PRUNEBATCHRESPONSE._serialized_start=2469
  _PRUNEBATCHRESPONSE._serialized_end=2525
  _PREFIXLOOKUPREQUEST._serialized_start=2527
  _PREFIXLOOKUPREQUEST._serialized_end=2567
  _PREFIXLOOKUPRESPONSE._serialized_start=2569
  _PREFIXLOOKUPRESPONSE._serialized_end=2614
  _TEXTGENERATIONSERVICE._serialized_start=2617
  _TEXTGENERATIONSERVICE._serialized_end=3271
# @@protoc_insertion_point(module_scope)
