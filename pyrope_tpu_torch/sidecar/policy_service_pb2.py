# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: policy_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14policy_service.proto\x12\x0epyrope.sidecar\"\x07\n\x05\x45mpty\"\x11\n\x03\x41\x63k\x12\n\n\x02ok\x18\x01 \x01(\x08\"\x80\x01\n\x14SystemMetricsRequest\x12\x11\n\ttenant_id\x18\x01 \x01(\t\x12\x0b\n\x03qps\x18\x02 \x01(\x01\x12\x17\n\x0f\x63\x61\x63he_miss_rate\x18\x03 \x01(\x01\x12\x16\n\x0ep99_latency_ms\x18\x04 \x01(\x01\x12\x17\n\x0f\x63pu_utilization\x18\x05 \x01(\x01\"]\n\x0eWarmPathPolicy\x12\x1b\n\x13\x61\x64mission_threshold\x18\x01 \x01(\x01\x12\x13\n\x0bttl_seconds\x18\x02 \x01(\x05\x12\x19\n\x11\x65viction_priority\x18\x03 \x01(\x05\"a\n\x0ePolicyResponse\x12.\n\x06policy\x18\x01 \x01(\x0b\x32\x1e.pyrope.sidecar.WarmPathPolicy\x12\x1f\n\x17next_report_interval_ms\x18\x02 \x01(\x05\"b\n\x12\x43lusterAccessEvent\x12\x11\n\ttenant_id\x18\x01 \x01(\t\x12\x12\n\nindex_name\x18\x02 \x01(\t\x12\x12\n\ncluster_id\x18\x03 \x01(\x05\x12\x11\n\ttimestamp\x18\x04 \x01(\x01\"H\n\x12\x43lusterAccessBatch\x12\x32\n\x06\x65vents\x18\x01 \x03(\x0b\x32\".pyrope.sidecar.ClusterAccessEvent\"\x16\n\x14PrefetchRulesRequest\"s\n\x0cPrefetchRule\x12\x11\n\ttenant_id\x18\x01 \x01(\t\x12\x12\n\nindex_name\x18\x02 \x01(\t\x12\x14\n\x0c\x66rom_cluster\x18\x03 \x01(\x05\x12\x12\n\nto_cluster\x18\x04 \x01(\x05\x12\x12\n\nconfidence\x18\x05 \x01(\x01\"D\n\x15PrefetchRulesResponse\x12+\n\x05rules\x18\x01 \x03(\x0b\x32\x1c.pyrope.sidecar.PrefetchRule\";\n\x12IndexPolicyRequest\x12\x11\n\ttenant_id\x18\x01 \x01(\t\x12\x12\n\nindex_name\x18\x02 \x01(\t\"P\n\x13IndexPolicyResponse\x12\x1a\n\x12recommended_nprobe\x18\x01 \x01(\x05\x12\x1d\n\x15recommended_ef_search\x18\x02 \x01(\x05\"v\n\x13ModelStatusResponse\x12\x16\n\x0e\x61\x63tive_version\x18\x01 \x01(\t\x12\x16\n\x0e\x63\x61nary_version\x18\x02 \x01(\t\x12\x16\n\x0e\x63\x61nary_tenants\x18\x03 \x03(\t\x12\x17\n\x0fstaged_versions\x18\x04 \x03(\t\"2\n\x10TrainingResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x0e\n\x06job_id\x18\x02 \x01(\t\"8\n\rDeployRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x16\n\x0e\x63\x61nary_tenants\x18\x02 \x03(\t\"P\n\x0e\x44\x65ployResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x16\n\x0e\x61\x63tive_version\x18\x02 \x01(\t\x12\x16\n\x0e\x63\x61nary_version\x18\x03 \x01(\t\"k\n\x0f\x45valuationEntry\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x11\n\tprecision\x18\x02 \x01(\x01\x12\x0e\n\x06recall\x18\x03 \x01(\x01\x12$\n\x1csimulated_p99_improvement_ms\x18\x04 \x01(\x01\"K\n\x13\x45valuationsResponse\x12\x34\n\x0b\x65valuations\x18\x01 \x03(\x0b\x32\x1f.pyrope.sidecar.EvaluationEntry2\xf6\x05\n\rPolicyService\x12[\n\x13ReportSystemMetrics\x12$.pyrope.sidecar.SystemMetricsRequest\x1a\x1e.pyrope.sidecar.PolicyResponse\x12N\n\x13ReportClusterAccess\x12\".pyrope.sidecar.ClusterAccessBatch\x1a\x13.pyrope.sidecar.Ack\x12_\n\x10GetPrefetchRules\x12$.pyrope.sidecar.PrefetchRulesRequest\x1a%.pyrope.sidecar.PrefetchRulesResponse\x12Y\n\x0eGetIndexPolicy\x12\".pyrope.sidecar.IndexPolicyRequest\x1a#.pyrope.sidecar.IndexPolicyResponse\x12L\n\x0eGetModelStatus\x12\x15.pyrope.sidecar.Empty\x1a#.pyrope.sidecar.ModelStatusResponse\x12J\n\x0fTriggerTraining\x12\x15.pyrope.sidecar.Empty\x1a .pyrope.sidecar.TrainingResponse\x12L\n\x0b\x44\x65ployModel\x12\x1d.pyrope.sidecar.DeployRequest\x1a\x1e.pyrope.sidecar.DeployResponse\x12\x46\n\rRollbackModel\x12\x15.pyrope.sidecar.Empty\x1a\x1e.pyrope.sidecar.DeployResponse\x12L\n\x0eGetEvaluations\x12\x15.pyrope.sidecar.Empty\x1a#.pyrope.sidecar.EvaluationsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'policy_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=40
  _EMPTY._serialized_end=47
  _ACK._serialized_start=49
  _ACK._serialized_end=66
  _SYSTEMMETRICSREQUEST._serialized_start=69
  _SYSTEMMETRICSREQUEST._serialized_end=197
  _WARMPATHPOLICY._serialized_start=199
  _WARMPATHPOLICY._serialized_end=292
  _POLICYRESPONSE._serialized_start=294
  _POLICYRESPONSE._serialized_end=391
  _CLUSTERACCESSEVENT._serialized_start=393
  _CLUSTERACCESSEVENT._serialized_end=491
  _CLUSTERACCESSBATCH._serialized_start=493
  _CLUSTERACCESSBATCH._serialized_end=565
  _PREFETCHRULESREQUEST._serialized_start=567
  _PREFETCHRULESREQUEST._serialized_end=589
  _PREFETCHRULE._serialized_start=591
  _PREFETCHRULE._serialized_end=706
  _PREFETCHRULESRESPONSE._serialized_start=708
  _PREFETCHRULESRESPONSE._serialized_end=776
  _INDEXPOLICYREQUEST._serialized_start=778
  _INDEXPOLICYREQUEST._serialized_end=837
  _INDEXPOLICYRESPONSE._serialized_start=839
  _INDEXPOLICYRESPONSE._serialized_end=919
  _MODELSTATUSRESPONSE._serialized_start=921
  _MODELSTATUSRESPONSE._serialized_end=1039
  _TRAININGRESPONSE._serialized_start=1041
  _TRAININGRESPONSE._serialized_end=1091
  _DEPLOYREQUEST._serialized_start=1093
  _DEPLOYREQUEST._serialized_end=1149
  _DEPLOYRESPONSE._serialized_start=1151
  _DEPLOYRESPONSE._serialized_end=1231
  _EVALUATIONENTRY._serialized_start=1233
  _EVALUATIONENTRY._serialized_end=1340
  _EVALUATIONSRESPONSE._serialized_start=1342
  _EVALUATIONSRESPONSE._serialized_end=1417
  _POLICYSERVICE._serialized_start=1420
  _POLICYSERVICE._serialized_end=2178
# @@protoc_insertion_point(module_scope)
